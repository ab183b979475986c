"""An engine's serve-time programs, one a bucket: the counterpart of the JAX
engine's ``_jitted`` dict and ``_warm_buckets``
(``deeprecsys_tpu/serving/engine.py:152, :525-542``; on a mesh the jitted
sharded apply and hot/cold programs, ``:279-290, :384-435``).

The JAX engine keeps one ``jax.jit`` executable a serve-time shape (each
bucket, its masked twin, each cold rung of a hot/cold engine, the direct
lookup a refreshing engine falls back to) and compiles every one before it
signals ready. Here, on a card, an engine captures each of those forwards
as a CUDA graph at warm-up and replays it for each execution: the rows are
copied into the program's static inputs (``non_blocking``, from pinned
memory), the graph is replayed and its static output copied out, all on the
engine's stream. A replay is one call into PyTorch where the eager forward
makes 34-50.

- ``StaticInputs``: the engine's device input buffers, at its largest bucket
  and cold rung (on a mesh, the mesh split's: a cold stream a cell); a
  program reads leading slices of them.
- ``BucketProgram``: one program: its slices, its forward (a closure over
  the params it was built with) and, on a card, its graph, its static
  output and the kernel launches its capture recorded, which each replay
  adds to the wrappers' counters (``_build.count_replay``).
- ``ProgramSet``: an engine's programs, sharing one graph memory pool. A
  reload builds a new set against the new params.

Building a program on a card runs its forward once eagerly (which builds the
kernels, creates cuBLAS's handle and workspace on the engine's stream and
fills the wrappers' host caches, none of which a capture may do), captures
it, replays it once and holds the replay to the eager output
(``warm_err``). On the CPU, which tests ask for, a program runs its forward
eagerly over the same static buffers, so the CPU tests reach the copy-in
and the slicing that a card replays; a card never runs the eager forward at
serve time, and a capture that fails raises.

A mesh engine builds the same programs over the mesh's forward. Where its
entries all name one device (one card's virtual shards) every shard's launch
and the combine run on the engine's one stream, and the program is captured
as on one device. A mesh over several cards, or across processes, stays
eager (``eager_reason``, decided when the engine is built): its programs run
the forward over the same static inputs, never a graph.

Captures run on the engine's stream with ``capture_error_mode=
"thread_local"`` (engines warm up in parallel threads, whose own streams
keep working), one program set being built in the process at a time
(``BUILD_LOCK``), and without ``torch.cuda.graph``'s device-wide
synchronize and cache flush, which would stall an engine that rebuilds
under traffic behind every other engine's work. The programs of a set share
one memory pool: safe because the engine's one stream runs their replays
one after another.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
from deeprecsys_tpu_torch.ops import _build

# Held while an engine builds a program set: one at a time in the process,
# so no capture overlaps another engine's eager warm-up (its first kernel
# loads) or capture.
BUILD_LOCK = threading.Lock()


def eager_reason(mesh):
    """Why the programs over ``mesh`` stay eager, or None where they are
    captured: without a mesh, and on a mesh of one process whose entries
    all name one device (one card's virtual shards, ``["cuda:0"] * 4``).
    The engines' and the trainers' rule."""
    if mesh is None:
        return None
    if mesh.multi_process:
        return ("a mesh across processes: its collectives run over torch.distributed "
                "(gloo through host copies), which a CUDA graph cannot capture")
    if len(mesh.distinct_devices) > 1:
        return ("a mesh over several cards in one process: captures across devices are "
                "not tried")
    return None


def capture(fn: Callable[[], torch.Tensor], pool, stream: torch.cuda.Stream) -> tuple:
    """Capture ``fn()`` as a CUDA graph into ``pool`` on ``stream`` (the
    current one), ``capture_error_mode="thread_local"``; a capture that fails
    raises. The launches the captured calls make (on this thread, or by
    another thread onto ``stream``: autograd's worker runs a backward there)
    are tallied, not counted. Returns ``(graph, out, launches, ms)``: the
    graph, ``fn``'s static output, the tally a replay adds
    (``_build.count_replay``) and the capture's host ms."""
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with _build.recording_launches(stream.cuda_stream) as launches:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated with fn
            raise
        graph.capture_end()
    return graph, out, launches, (time.perf_counter() - t0) * 1000.0


def pool_bytes(pool):
    """Device bytes a graph pool holds (its segments in the caching
    allocator's snapshot); None without a pool (the CPU)."""
    if pool is None:
        return None
    pool = tuple(pool)
    return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class StaticInputs:
    """Device buffers for every input a program reads, at the engine's
    largest bucket: the rows (``dense``, ``indices``, with ``masked`` the
    ``mask``) and, with ``hotcold``, the split's flat arrays (room for every
    lookup and the largest cold rung; on a mesh a cold stream a cell of the
    split, as ``engine._Slot`` holds it)."""

    def __init__(self, cfg: ModelConfig, rows: int, masked: bool, hotcold: bool,
                 device: torch.device, mesh=None):
        T, L = cfg.num_tables, cfg.num_indices_per_lookup

        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        self.shape = (T, L)
        self.mesh = mesh
        self.indices = buf((rows, T, L), torch.int32)
        self.dense = buf((rows, cfg.dense_dim), torch.float32) if cfg.dense_dim else None
        self.mask = buf((rows, T, L), torch.bool) if masked else None
        self.split = None
        if hotcold:
            n, cold = rows * T * L, max(cold_buckets_for(rows * T * L, mesh))
            cells = 1 if mesh is None else mesh.size
            self.split = {"hot_sel": buf((n,), torch.int32), "hot_mask": buf((n,), torch.bool),
                          self.cold_key: buf((cells * cold,), torch.int32),
                          "cold_seg": buf((cells * cold,), torch.int32)}

    @property
    def cold_key(self) -> str:
        """The split's name for its cold ids: ``cold_ids`` on one device,
        ``cold_local`` (each shard's own ids) on a mesh."""
        return "cold_ids" if self.mesh is None else "cold_local"

    def rows(self, bucket: int, masked: bool) -> dict:
        """The slices a direct (``masked``: masked) program of ``bucket`` reads."""
        out = {"indices": self.indices[:bucket]}
        if self.dense is not None:
            out["dense"] = self.dense[:bucket]
        if masked:
            out["mask"] = self.mask[:bucket]
        return out

    def split_of(self, bucket: int, c_pad: int) -> dict:
        """The slices a hot/cold program of ``bucket`` at cold rung ``c_pad``
        reads, shaped as the lookup takes the split (and the dense rows): K6's
        ``(C_pad,)`` stream on one device; on a mesh ``(M, C_pad)``
        (tensor-parallel) or ``(D, M, C_pad)`` (hybrid) streams, each cell's
        contiguous."""
        T, L = self.shape
        n = bucket * T * L
        if self.mesh is None:
            cold = (c_pad,)
        elif self.mesh.shape["data"] == 1:
            cold = (self.mesh.shape["model"], c_pad)
        else:
            cold = (self.mesh.shape["data"], self.mesh.shape["model"], c_pad)
        n_cold = int(np.prod(cold))
        out = {"hot_sel": self.split["hot_sel"][:n].view(bucket, T, L),
               "hot_mask": self.split["hot_mask"][:n].view(bucket, T, L),
               self.cold_key: self.split[self.cold_key][:n_cold].view(cold),
               "cold_seg": self.split["cold_seg"][:n_cold].view(cold)}
        if self.dense is not None:
            out["dense"] = self.dense[:bucket]
        return out


class BucketProgram:
    """One serve-time program: ``forward(inputs)`` over the static slices
    ``inputs`` (a dict by name), captured as a graph where ``capture`` (on
    a card, but an eager mesh engine's)."""

    def __init__(self, key: tuple, forward: Callable[[dict], torch.Tensor], inputs: dict,
                 device: torch.device, capture: bool):
        self.key = key
        self.forward = forward
        self.inputs = inputs
        self.device = device
        self.capture = capture
        self.graph = None
        self.out = None          # the graph's static output (a card)
        self.launches: dict = {}  # wrapper -> launches a replay (a card)
        self.capture_ms = 0.0
        self.warm_err = None     # max |first replay - eager forward| (a card)
        self.first_scores = None  # the first run's scores after capture, f32 on the host
        self.runs = 0            # executions served after the build (serve thread)

    def load(self, host: dict):
        """Copy an execution's host rows (pinned on a card) into the static
        slices, on the current stream."""
        on_card = self.device.type == "cuda"
        for name, dst in self.inputs.items():
            dst.copy_(host[name], non_blocking=on_card)

    def run(self, host: dict) -> torch.Tensor:
        """One execution: copy ``host`` in, then replay (a card) or run the
        forward (the CPU, an eager mesh engine). Returns the output."""
        self.runs += 1
        self.load(host)
        if self.graph is None:
            return self.forward(self.inputs)
        self.graph.replay()
        _build.count_replay(self.launches)
        return self.out

    def build(self, host: dict, pool) -> int:
        """Warm the program on ``host``'s rows; on a card capture it into
        ``pool`` on the current stream and replay it once. Returns the
        executions run (the CPU or an eager program 1; a capture 2, the
        eager forward and the replay)."""
        if not self.capture:
            self.load(host)
            self.first_scores = self.forward(self.inputs).float().cpu().numpy()
            return 1
        self.load(host)
        eager = self.forward(self.inputs)
        self.graph, self.out, self.launches, self.capture_ms = capture(
            lambda: self.forward(self.inputs), pool, torch.cuda.current_stream(self.device))
        self.graph.replay()
        _build.count_replay(self.launches)
        self.warm_err = float((self.out.float() - eager.float()).abs().max().item())
        self.first_scores = self.out.float().cpu().numpy()
        return 2


class ProgramSet:
    """An engine's programs by key: ``("direct", bucket)``, ``("masked",
    bucket)``, ``("hotcold", bucket, cold_rung)``. On a card they share one
    graph memory pool (``capture`` False: none, the programs stay eager)."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.programs: dict[tuple, BucketProgram] = {}
        self.executions = 0  # warm-up executions the builds ran
        self.captures = 0
        self.capture_ms = 0.0

    def add(self, key: tuple, forward: Callable[[dict], torch.Tensor], inputs: dict,
            host: dict) -> BucketProgram:
        prog = BucketProgram(key, forward, inputs, self.device, self.capture)
        self.executions += prog.build(host, self.pool)
        if prog.graph is not None:
            self.captures += 1
            self.capture_ms += prog.capture_ms
        self.programs[key] = prog
        return prog

    def __getitem__(self, key: tuple) -> BucketProgram:
        return self.programs[key]

    def __iter__(self):
        return iter(self.programs.values())

    def __len__(self) -> int:
        return len(self.programs)

    def pool_bytes(self):
        """Device bytes the set's graph pool holds; None on the CPU."""
        return pool_bytes(self.pool)


def pad_cold(split: dict, c_pad: int, n_bags: int) -> dict:
    """``split`` (an unpadded host split, ``pad=False``; or a mesh split,
    each cell's stream padded) with each cold stream cut or padded to
    ``c_pad`` entries: cut, it is the split of a batch whose later cold
    lookups are masked out; pads are id 0 in bag ``n_bags`` (a data slice's
    bags on a hybrid mesh), as the splitters pad."""
    key = "cold_ids" if "cold_ids" in split else "cold_local"
    ids, seg = np.asarray(split[key]), np.asarray(split["cold_seg"])
    n = min(ids.shape[-1], c_pad)
    cold_ids = np.zeros(ids.shape[:-1] + (c_pad,), np.int32)
    cold_seg = np.full(ids.shape[:-1] + (c_pad,), n_bags, np.int32)
    cold_ids[..., :n], cold_seg[..., :n] = ids[..., :n], seg[..., :n]
    return {"hot_sel": split["hot_sel"], "hot_mask": split["hot_mask"],
            key: cold_ids, "cold_seg": cold_seg}
