from deeprecsys_tpu_torch.ops.embedding import (
    embedding_bag,
    embedding_bag_reference,
    init_fused_tables,
    unpack_table,
)
from deeprecsys_tpu_torch.ops.mlp import mlp_init, mlp_apply
from deeprecsys_tpu_torch.ops.interactions import cat_interaction

__all__ = [
    "embedding_bag",
    "embedding_bag_reference",
    "init_fused_tables",
    "unpack_table",
    "mlp_init",
    "mlp_apply",
    "cat_interaction",
]
