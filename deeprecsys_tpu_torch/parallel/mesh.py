"""The device mesh (counterpart of ``deeprecsys_tpu/parallel/mesh.py``).

The JAX package runs one program over a 2-D ``jax.sharding.Mesh`` from one
thread; the port does the same, with no ``torch.distributed``: a ``Mesh``
is a ``(data, model)`` array of ``torch.device``s, and the sharded paths
(``parallel/sharding.py``) launch each entry's work on that entry's device
from the calling thread and combine the results in-process.

- axis "data": the batch splits into ``data`` contiguous slices, slice d
  runs on row d of the mesh;
- axis "model": the fused table's rows split into ``model`` shards, shard m
  lives on column m; a lookup's per-shard partial sums are added on the
  row's first entry (the JAX package's ``psum`` over "model").

Entries may name the same device. That is the port's counterpart of the
JAX tests' ``xla_force_host_platform_device_count``: the CPU tests run every
mesh path on ``make_mesh(..., devices=["cpu"] * 8)``, and one card runs a
1x4, 2x2 or 4x1 mesh of ``cuda:0``. Every sharded code path, per-shard
kernel launch and combine then runs, but nothing shows how a mesh of
several cards scales. Multi-process meshes (``distributed_init``) are not
ported yet (ROADMAP.md Queue 1 item 12b).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s (JAX ``Mesh`` with axis
    names ``("data", "model")``). ``devices`` is the ``(D, M)`` object
    array, ``shape`` ``{"data": D, "model": M}``."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, model); got shape {devices.shape}")
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d, m]

    @property
    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(devices=None) takes every visible CUDA device, and no "
                           "CUDA card is available (pass devices=['cpu'] * n for a CPU mesh)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device) -> torch.device:
    """A card by its index (``cuda`` -> ``cuda:<current>``), as tensors name it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int | None = None, model: int | None = None, devices=None) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (default: every visible
    CUDA device; without a card it raises, never taking the CPU). With
    only one of data/model given, the other takes the remaining devices;
    with neither, every device is on the data axis (JAX ``mesh.py:23-43``).
    A shape that does not cover the devices raises ``ValueError``."""
    if devices is None:
        devices = _visible_cuda_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if n % model:
            raise ValueError(f"model axis {model} does not divide {n} devices")
        data = n // model
    elif model is None:
        if n % data:
            raise ValueError(f"data axis {data} does not divide {n} devices")
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    for i, dev in enumerate(devices):
        arr[i] = dev
    return Mesh(arr.reshape(data, model))


def distributed_init(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-process initialization (JAX ``mesh.py:46-58``): a no-op for one
    process, as there. Several processes (``torch.distributed``) are not
    ported yet (ROADMAP.md Queue 1 item 12b) and raise."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError("multi-process meshes (distributed_init with num_processes > 1) "
                              "are not ported yet (ROADMAP.md Queue 1 item 12b)")
