"""Device selection (counterpart of ``deeprecsys_tpu/utils/devices.py``).

Asking for ``cuda`` on a machine without a card is an error: the port never
moves to the CPU on its own, so a CPU number can never pass for a GPU one.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:<i>"`` as a ``torch.device``."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {name!r} (valid: 'cpu', 'cuda')")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for, but no CUDA card is available")
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {name!r} does not exist: "
                           f"{torch.cuda.device_count()} card(s) present")
    return device


def synchronize(device: torch.device):
    """Wait for the work queued on ``device``; a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
