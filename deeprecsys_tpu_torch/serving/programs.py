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
- ``StagedProgram``: stages run in order, a graph a stage on its card, the
  outputs that cross cards copied between the replays; the trainers' steps
  over several cards share it (``train_programs.py::StagedStep``).
- ``BucketProgram``: one program: its slices, its stages (closures over
  the params it was built with; one a card) and, on a card, a graph a
  stage, the static outputs and the kernel launches the captures recorded,
  which each replay adds to the wrappers' counters
  (``_build.count_replay``).
- ``ProgramSet``: an engine's programs, sharing one graph memory pool a
  card. A reload builds a new set against the new params.

Building a program on a card runs its forward once eagerly (which builds the
kernels, creates cuBLAS's handle and workspace on the engine's stream and
fills the wrappers' host caches, none of which a capture may do), captures
it, replays it once and holds the replay to the eager output
(``warm_err``). On the CPU, which tests ask for, a program runs its forward
eagerly over the same static buffers, so the CPU tests reach the copy-in
and the slicing that a card replays; a card never runs the eager forward at
serve time, and a capture that fails raises.

A mesh engine builds the same programs over the mesh's forward, cut into
parts by card (``parallel/sharding.py::card_plan``, ``mesh_stages``): a
program is a list of stages, each the work of one card. Where the entries
all name one card (its virtual shards) that is one stage, captured as on
one device. Over several cards of one process each card's stage is
captured on the engine's stream of that card into a graph pool of that
card: PyTorch's private pool belongs to the capturing device alone, so one
graph over several cards would take the other cards' memory from their
ordinary pools. Every tensor a stage reads from another card is a static
buffer on its own card (``recv``), allocated by the eager run before the
captures, and the copies into it run between the replays, as a
cross-device ``copy_`` on the two cards' engine streams, which PyTorch
orders by events and not by a host wait. The rows are copied from pinned
memory straight into each card's static inputs, only the pieces that card
reads. An engine serves a mesh from one process only
(``Mesh.require_one_process``); ``eager_reason`` gives a mesh across
processes its reason by backend.

Captures run on the engine's streams with ``capture_error_mode=
"thread_local"`` (engines warm up in parallel threads, whose own streams
keep working), one program set being built in the process at a time
(``BUILD_LOCK``, held over every card's captures of a set), and without
``torch.cuda.graph``'s device-wide synchronize and cache flush, which
would stall an engine that rebuilds under traffic behind every other
engine's work. The programs of a set share one memory pool a card: safe
because the engine's one stream on each card runs their replays one after
another.
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
    """Why an engine's programs over ``mesh`` stay eager, or None where they
    are captured: without a mesh, and on a mesh of one process, whether its
    entries name one card or several (one graph a card). A mesh across
    processes gives its reason by backend, though an engine over one raises
    before it asks (``Mesh.require_one_process``). The trainers' rule is
    their own (``train_programs.eager_reason``)."""
    if mesh is None or not mesh.multi_process:
        return None
    if mesh.backend != "nccl":
        return (f"a mesh across processes over {mesh.backend}: its collectives run through "
                "host copies, which a CUDA graph cannot capture")
    return ("a mesh across processes over nccl: an engine serves a mesh from one process "
            "only, as the JAX package's does (Mesh.require_one_process)")


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


def pool_bytes_by_card(pools) -> dict:
    """Device bytes the graph pools ``pools`` hold, by card index (a card
    whose pools hold no segment is left out)."""
    ids = {tuple(p) for p in pools}
    out: dict = {}
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) in ids:
            out[seg["device"]] = out.get(seg["device"], 0) + int(seg["total_size"])
    return out


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


class StagedProgram:
    """Stages (``parallel.sharding.Stage``) run in order, each captured as a
    graph on its card, and the outputs a stage sends another card copied
    between the replays into receive buffers there (``recv``, allocated by
    the first, eager run). The send and replay loop of the engines' programs
    and of the trainers' steps over several cards. ``out`` is the output
    ``"out"`` of the stage that makes it."""

    def __init__(self, stages: list):
        self.stages = stages
        self.graphs: list = []   # a graph a stage (a card)
        self.outs: list = []     # each stage's static outputs (a card)
        self.recv: dict = {}     # the buffers a stage reads from another card's stage
        self.launches: dict = {}  # wrapper -> launches a replay, every stage's (a card)
        self.stage_launches: list = []  # (card, wrapper -> launches) a stage (a card)
        self.stage_ms: list = []  # each stage's capture, host ms (a card)
        self.capture_ms = 0.0
        self._out_at = len(stages) - 1  # the stage whose outputs hold "out"

    @property
    def graph(self):
        """The last stage's graph; None where the program runs eagerly."""
        return self.graphs[-1] if self.graphs else None

    @property
    def out(self) -> torch.Tensor | None:
        """The output's static tensor (a card)."""
        return self.outs[self._out_at]["out"] if self.outs else None

    def _send(self, stage, outs: dict):
        """Copy each output of ``stage`` that another stage reads into its
        receive buffer (allocated by the first, eager run): on a card a
        cross-device ``copy_``, ordered by events on both cards' current
        streams. A key the stage did not output this time is skipped."""
        for key, dev in stage.sends.items():
            src = outs.get(key)
            if src is None:
                continue
            dst = self.recv.get(key)
            if dst is None:
                dst = self.recv[key] = torch.empty(src.shape, dtype=src.dtype, device=dev)
            dst.copy_(src, non_blocking=dev.type == "cuda")

    def _eager(self) -> torch.Tensor:
        out = None
        for i, stage in enumerate(self.stages):
            outs = stage.fn(self.recv)
            self._send(stage, outs)
            if "out" in outs:
                out, self._out_at = outs["out"], i
        return out

    def _replay(self) -> torch.Tensor:
        for stage, graph, outs in zip(self.stages, self.graphs, self.outs):
            graph.replay()
            self._send(stage, outs)
        _build.count_replay(self.launches)
        return self.out

    def _capture(self, pools: dict):
        """Capture each stage on its card's current stream into that card's
        pool (``pools`` by device), in order; a stage reads the receive
        buffers the eager run allocated, and the static outputs of the
        stages captured before it."""
        for stage in self.stages:
            with torch.cuda.device(stage.device):
                graph, outs, launches, ms = capture(
                    lambda: stage.fn(self.recv), pools[stage.device],
                    torch.cuda.current_stream(stage.device))
            self.graphs.append(graph)
            self.outs.append(outs)
            self.stage_launches.append((stage.device, launches))
            self.stage_ms.append(ms)
            for wrapper, n in launches.items():
                self.launches[wrapper] = self.launches.get(wrapper, 0) + n
            self.capture_ms += ms


class BucketProgram(StagedProgram):
    """One serve-time program: its ``stages`` (``parallel.sharding.Stage``:
    one on one device or one card, one a card and job over several cards)
    over the static slices they read, each stage captured as a graph where
    ``capture`` (on a card, unless the engine states an eager reason). ``inputs``: the
    slices by name on the output's card; ``loads``: ``(dst, name, index)``,
    each static slice and the piece ``host[name][index]`` copied into it
    (``index`` () for a whole array), every card's."""

    def __init__(self, key: tuple, stages: list, inputs: dict, loads: list,
                 device: torch.device, capture: bool):
        super().__init__(stages)
        self.key = key
        self.inputs = inputs
        self.loads = loads
        self.device = device
        self.capture = capture
        self.warm_err = None     # max |first replay - eager forward| (a card)
        self.first_scores = None  # the first run's scores after capture, f32 on the host
        self.runs = 0            # executions served after the build (serve thread)

    def load(self, host: dict):
        """Copy an execution's host rows (pinned on a card) into the static
        slices, on the current stream of each slice's card."""
        on_card = self.device.type == "cuda"
        for dst, name, index in self.loads:
            src = host[name]
            dst.copy_(src[index] if index else src, non_blocking=on_card)

    def run(self, host: dict) -> torch.Tensor:
        """One execution: copy ``host`` in, then replay every stage (a card)
        or run the stages eagerly (the CPU, an eager program). Returns the
        output."""
        self.runs += 1
        self.load(host)
        return self._replay() if self.graphs else self._eager()

    def build(self, host: dict, pools: dict) -> int:
        """Warm the program on ``host``'s rows; on a card capture each stage
        on its card's current stream into that card's pool (``pools`` by
        device) and replay the program once. Returns the executions run
        (the CPU or an eager program 1; a capture 2, the eager forward and
        the replay)."""
        self.load(host)
        if not self.capture:
            self.first_scores = self._eager().float().cpu().numpy()
            return 1
        eager = self._eager()
        self._capture(pools)
        out = self._replay()
        self.warm_err = float((out.float() - eager.float()).abs().max().item())
        self.first_scores = out.float().cpu().numpy()
        return 2


class ProgramSet:
    """An engine's programs by key: ``("direct", bucket)``, ``("masked",
    bucket)``, ``("hotcold", bucket, cold_rung)``. On a card they share one
    graph memory pool a card of ``devices`` (``capture`` False: none, the
    programs stay eager)."""

    def __init__(self, device: torch.device, capture: bool = True, devices=None):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.pools = ({dev: torch.cuda.graph_pool_handle() for dev in (devices or [device])}
                      if self.capture else {})
        self.programs: dict[tuple, BucketProgram] = {}
        self.executions = 0  # warm-up executions the builds ran
        self.captures = 0    # programs captured (each a graph a stage)
        self.capture_ms = 0.0

    def add(self, key: tuple, stages: list, inputs: dict, host: dict,
            loads: list | None = None) -> BucketProgram:
        """Build the program ``key`` of ``stages``, warmed on ``host``;
        ``loads`` None: ``inputs`` whole, each from ``host`` by its name."""
        if loads is None:
            loads = [(dst, name, ()) for name, dst in inputs.items()]
        prog = BucketProgram(key, stages, inputs, loads, self.device, self.capture)
        self.executions += prog.build(host, self.pools)
        if prog.graphs:
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

    def pool_bytes_by_card(self) -> dict:
        """Device bytes the set's graph pools hold, by card index; empty on
        the CPU."""
        return pool_bytes_by_card(self.pools.values()) if self.capture else {}


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
