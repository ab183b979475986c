"""The device mesh (counterpart of ``deeprecsys_tpu/parallel/mesh.py``).

The JAX package runs one program over a 2-D ``jax.sharding.Mesh``; the port
does the same: a ``Mesh`` is a ``(data, model)`` array of
``torch.device``s, and the sharded paths (``parallel/sharding.py``) launch
each entry's work on that entry's device from the calling thread.

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
several cards scales.

Across processes (``distributed_init``, the counterpart of JAX's global
mesh under ``jax.distributed``): ``make_mesh`` gathers every process's
local devices in rank order, the order of ``jax.devices()`` there, so each
entry has an owning rank (``rank_of``). A process places and launches only
on its own entries (``is_local``); the combines that one process does in
place become collectives over ``torch.distributed``, each over the ranks
that hold the data (``row_ranks``, ``col_ranks``, ``all_ranks``): a process
group a row and a column, made once a mesh, and the world for the mesh's
own combines (the concat over "data", the loss, the replicated leaves'
gradients, the shards' gather). A mesh of one process makes no
collective call.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s (JAX ``Mesh`` with axis
    names ``("data", "model")``). ``devices`` is the ``(D, M)`` object
    array, ``shape`` ``{"data": D, "model": M}``; ``ranks`` the ``(D, M)``
    owning process of each entry (None: every entry is this process's).
    A mesh over several processes is built on all of them, in the same
    order (``make_mesh``): it makes its process groups here."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D (data, model); got shape {devices.shape}")
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(devices.shape))
        self.multi_process = len(set(self.ranks.flat)) > 1
        self.rank = dist.get_rank() if self.multi_process else 0
        self.backend = dist.get_backend() if self.multi_process else None
        self._groups: dict = {}
        if self.multi_process:
            # new_group is collective over the whole world: every process
            # makes the same groups in the same order. The mesh's own rank
            # set is the world (make_mesh gathers every process's devices).
            world = tuple(range(dist.get_world_size()))
            for ranks in ([self.all_ranks]
                          + [self.row_ranks(d) for d in range(self.shape["data"])]
                          + [self.col_ranks(m) for m in range(self.shape["model"])]):
                if len(ranks) > 1 and ranks not in self._groups:
                    self._groups[ranks] = (None if ranks == world
                                           else dist.new_group(list(ranks)))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d, m]

    def rank_of(self, d: int, m: int) -> int:
        """The process that holds entry (d, m)."""
        return int(self.ranks[d, m])

    def is_local(self, d: int, m: int) -> bool:
        return self.rank_of(d, m) == self.rank

    def row_ranks(self, d: int) -> tuple:
        """The processes of data row d, ascending."""
        return tuple(sorted(set(int(r) for r in self.ranks[d])))

    def col_ranks(self, m: int) -> tuple:
        """The processes of model column m (shard m's copies), ascending."""
        return tuple(sorted(set(int(r) for r in self.ranks[:, m])))

    @property
    def all_ranks(self) -> tuple:
        return tuple(sorted(set(int(r) for r in self.ranks.flat)))

    @property
    def distinct_devices(self) -> list:
        """This process's devices, each once, in row-major order."""
        return list(dict.fromkeys(dev for dev, r in zip(self.devices.flat, self.ranks.flat)
                                  if r == self.rank))

    @property
    def home(self) -> torch.device:
        """This process's first device: where its whole-batch results land
        (``devices.flat[0]`` on one process)."""
        return self.distinct_devices[0]

    def require_one_process(self, what: str):
        """Raise for a path that runs on one process's mesh only: the mesh
        engines, which the JAX package also runs from one process."""
        if self.multi_process:
            raise NotImplementedError(
                f"{what} serves a mesh from one process: the JAX package's engine does the "
                "same and has no engine over several processes (no leader that broadcasts "
                "each execution's batch, no refresh across processes), so the port has none "
                "(ROADMAP.md Queue 1 item 12c); the forward, the hot/cold and table-wise "
                "models and the trainers run across processes")

    # -- collectives (only where ``ranks`` holds more than this process) --

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where this process's collectives run. On gloo, a
        host copy: gloo takes card tensors only for some collectives, so a
        partial or a score on a card goes through the host and comes back.
        On nccl, a copy on this process's first card: NCCL keeps one
        communicator a group and card, and a process that used two cards in
        one group would wait on a peer that used one."""
        return t.detach().to(self._where, copy=True).contiguous()

    @property
    def _where(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.home

    def all_reduce(self, t: torch.Tensor, ranks: tuple) -> torch.Tensor:
        """``t`` summed over the processes ``ranks`` (this one among them),
        on ``t``'s device; ``t`` itself where ``ranks`` is this process."""
        return self.all_reduce_flat([t], ranks)[0]

    def all_reduce_flat(self, ts: list, ranks: tuple) -> list:
        """The tensors ``ts`` (one dtype) each summed over the processes
        ``ranks`` by one all-reduce: flattened in order into one buffer
        where this process's collectives run (``_staged``'s place), reduced,
        and each read back as a view (on its own device: a copy where that
        is elsewhere). ``ts`` itself where ``ranks`` is this process."""
        if len(ranks) == 1:
            return ts
        buf = (self._staged(ts[0]).reshape(-1) if len(ts) == 1
               else torch.cat([t.detach().reshape(-1).to(self._where) for t in ts]))
        dist.all_reduce(buf, group=self._groups[ranks])
        out, at = [], 0
        for t in ts:
            out.append(buf[at:at + t.numel()].view(t.shape).to(t.device))
            at += t.numel()
        return out

    def broadcast(self, t: torch.Tensor, src: int, ranks: tuple) -> torch.Tensor:
        """Process ``src``'s ``t`` on every process of ``ranks``, on ``t``'s
        device (elsewhere ``t`` is a buffer of its shape and dtype)."""
        if len(ranks) == 1:
            return t
        buf = self._staged(t)
        dist.broadcast(buf, src=src, group=self._groups[ranks])
        return t if self.rank == src else buf.to(t.device)

    def __repr__(self) -> str:
        where = "" if not self.multi_process else f", ranks={self.ranks.flatten().tolist()}"
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"devices={[str(d) for d in self.devices.flat]}{where})")


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
    A shape that does not cover the devices raises ``ValueError``.

    Under a process group of several processes (``distributed_init``),
    ``devices`` are this process's own (``["cpu", "cpu"]`` is the JAX
    tests' ``xla_force_host_platform_device_count=2``; by default its
    visible cards, so give each process its own cards), and the mesh is
    built from every process's, gathered in rank order: every process
    calls ``make_mesh`` with the same shape, and ``make_mesh(data=2,
    model=2)`` over two processes of two devices puts process 0 on data
    row 0, as JAX's global mesh does."""
    if devices is None:
        devices = _visible_cuda_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    ranks = None
    if _world_size() > 1:
        gathered = [None] * _world_size()
        first = devices[0]
        with torch.cuda.device(first) if first.type == "cuda" else contextlib.nullcontext():
            dist.all_gather_object(gathered, [str(d) for d in devices])
        devices = [torch.device(s) for names in gathered for s in names]
        ranks = [r for r, names in enumerate(gathered) for _ in names]
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
    return Mesh(arr.reshape(data, model),
                None if ranks is None else np.asarray(ranks).reshape(data, model))


def distributed_init(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None):
    """Multi-process initialization (JAX ``mesh.py:46-58``, which calls
    ``jax.distributed.initialize``): ``torch.distributed.init_process_group``
    over ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this
    one ``process_id``. A no-op for one process and for a group already
    initialised, as in JAX.

    ``backend``: ``"nccl"`` where this process's devices are cards,
    ``"gloo"`` for CPU processes; by default ``"nccl"`` when a card is
    visible, else ``"gloo"``. It is never switched after a failure: NCCL
    refuses two ranks on one card, so processes that share a card name
    ``"gloo"`` themselves."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("distributed_init over several processes needs coordinator_address "
                         "and process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (use 'nccl' or 'gloo')")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs CUDA cards, and none is available "
                           "(CPU processes take 'gloo')")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
