from deeprecsys_tpu_torch.data.generator import RecDataGenerator

__all__ = ["RecDataGenerator"]
