"""Inference engines.

Counterpart of ``deeprecsys_tpu/serving/engine.py`` (reference
``inferenceEngine.py``: one process an engine, a feed thread and a thread
that stamps ``inference_end_time`` when the net finishes;
``accelInferenceEngine.py``: a latency-table lookup and a sleep).

Engines are threads of one process sharing the card, as in the JAX
package. ``ComputeEngine`` serves every request at a static batch bucket
(the smallest of the ladder that holds it) from rows generated once at the
largest bucket and sliced, the reference's "pre-generate at max size then
slice" (``inferenceEngine.py:200-206``). As the JAX engine compiles one
program a bucket (its masked twin, each cold rung, the direct lookup)
before it signals ready, also on a mesh, an engine builds one
``programs.BucketProgram`` for each at warm-up: on a card a CUDA graph of
the forward, captured on the engine's stream, which each execution replays
over static device inputs (the rows copied in, the scores copied out); on
the CPU the same program runs the eager forward over the same buffers. A
mesh engine over several cards captures a graph a card for each program.
Two threads an engine: the serve thread assembles and dispatches, the
completion thread waits for the scores and answers. ``SimEngine`` sleeps a
``LatencyModel``'s time instead of computing.

On a CUDA card, each engine:

- makes its own CUDA stream in its own thread and enters
  ``torch.inference_mode()`` and ``torch.cuda.stream`` there (both are
  thread-local), so K1 and K3, which launch on the calling thread's current
  stream, land on the engine's stream;
- copies each execution's rows from pinned host memory with
  ``non_blocking=True`` into its program's static inputs: the
  pre-generated rows of each bucket are pinned once, and a payload group is
  assembled into one of ``IN_FLIGHT`` pinned staging slots, which is reused
  only after its execution was answered;
- replays the program's graph, so the serve loop issues no eager forward
  op, and the launches the capture recorded are added to the kernels'
  counters at each replay;
- copies the scores back with ``non_blocking=True`` into the slot's pinned
  buffer and records an event on its stream; the completion thread waits
  on that event (the GIL released), where a device error surfaces and is
  answered with ``ERR_READBACK``.

A request's payload is checked on the host before it reaches the card: a
wrong shape, or an id outside ``[0, rows[t])``, is answered with
``ERR_PAYLOAD``. K1 does not check ids. The JAX package's gather adds the
table's offset first, so there an id just past its own table reads the
next table's row, and only an id past the whole fused table gives NaN
(ROADMAP.md Queue 3, deliberate differences).

Hot/cold serving (``embedding_impl="hotcold"``, or ``"auto"`` when the
sampled hot set covers at least ``hotcold_min_hit`` of the engine's stream
and the table is at least ``hotcold_min_table_mb``), as the JAX package's
engine does it on one device (its ``engine.py:326-380, :806-1194``): at
set-up the hot set is chosen from the engine's own data stream and the
params gain a ``(K, d)`` hot table; per execution the serve thread splits
the batch on the host (``models/hotcold.py::prepare``, the native splitter,
with the engine's own ``HotIndex``) straight into the execution's pinned
staging slot, the split arrays are copied with ``non_blocking=True``, and
K6 pools them (the ragged mask is consumed by the split, so the device call
is mask-free; nothing reads the cold count back from the card). With
``hotcold_refresh_interval > 0`` the engine tracks the live hit rate and,
every interval, upgrades, refreshes or disables the hot set and re-enables
it when a head returns. A scan worker thread only computes candidate ids
and their ``HotIndex``; it launches nothing. The swap happens on the serve
thread: the new hot rows are written into the hot table the programs read
(``index_select`` on the engine's stream, so executions queued before it
read the old rows; on a mesh the rows gathered from the shards that own
them, written into the hot table on each distinct device); a hot set of
another size rebuilds the programs. The engine made that table itself
(``convert_params``): a caller's params are never written.

Checkpoint reload (JAX ``engine.py:65-86, :732-804``): ``request_reload``
hands the engine a ``ReloadHandle`` from any thread; the serve thread
applies it before the next execution it dispatches (or within 0.5 s when
idle). On a card the new params are loaded on the serve thread, so on the
engine's stream (a mesh engine shards them), the programs are rebuilt
(captured again) against them, and the old programs and params are dropped
only after the engine's stream on each of its devices has finished the
executions queued on it, which read them. Both copies live during the swap;
a rebuild that fails keeps the old ones serving. A hot/cold engine derives
its hot table from the new tables; its hot ids stay.

A cpu-mp engine process (``process_engine.py``) runs this same engine on
the CPU over shared-memory rings: the reload path arrives as fragments on
its control ring and is acknowledged on the response ring
(``RELOAD_ACK_BATCH_ID``), and a request's features arrive in, and its
scores go back through, a blob-arena slot (JAX ``engine.py:1195-1286,
:1501-1510``).

With ``mesh=`` (a ``parallel.make_mesh`` mesh; JAX ``engine.py:140-151,
:279-488, :785-792, :1095-1151``) the engine serves over the mesh from its
own thread: the buckets round up to a multiple of the "data" axis, the
params are placed by ``parallel.shard_params`` (the table row-sharded over
"model"), the direct path runs ``parallel.sharded_apply``'s forward and a
hot/cold engine the mesh split (tensor-parallel when "data" is 1, hybrid
otherwise), each cut into parts by card (``parallel/sharding.py::
card_plan``, ``mesh_stages``) as its programs: the rows, or the split
staged in the slot, are copied into the static inputs of each card
(``StaticInputs`` a card, holding the mesh split's streams), only the
pieces that card reads, then each card's part runs. On one card's virtual
shards (every entry one device) that is one part, a replay of the captured
forward: every shard's launch and the combine, on the engine's one stream.
Over several cards each card's part is a graph replayed on the engine's
stream of that card, and the partials and slices that cross cards are
copied between the replays into static buffers on the receiving card. The
engine's device is the mesh's first entry, where the scores land; the
engine makes a stream on every distinct mesh device in its thread, and an
execution completes when an event on each of them has passed. A refresh
gathers the new hot table's rows from the shards that own them and writes
them into the hot table on each card; a reload loads the checkpoint on the
first device and shards it.
The orchestrator, ``build_engine_pool`` and the ingress pass ``mesh`` on to
thread engines (cpu-mp engine processes refuse one, as in the JAX package).
There is no TPU layout negotiation to port: a checkpoint is loaded against
the engine's model config, which fixes every shape and dtype.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time

import numpy as np
import torch

from deeprecsys_tpu_torch import bridge
from deeprecsys_tpu_torch.config import ModelConfig, ServingConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch, compute_dtype_of
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel
from deeprecsys_tpu_torch.serving.programs import (
    BUILD_LOCK, ProgramSet, StaticInputs, eager_reason, pad_cold)
from deeprecsys_tpu_torch.serving.packets import (
    ERR_DEADLINE,
    ERR_OVER_LADDER,
    ERR_PAYLOAD,
    ERR_READBACK,
    ERR_RELOAD,
    RELOAD_ACK_BATCH_ID,
    ServiceRequest,
    ServiceResponse,
)
from deeprecsys_tpu_torch.utils.devices import resolve_device

_SENTINEL = None
# _hydrate's mark of a request it already answered with an error; never
# None, which is the shutdown sentinel.
_DROPPED = object()
# Executions an engine keeps in flight: its pinned staging slots. The serve
# thread waits for a free slot when all are taken.
IN_FLIGHT = 4


class ReloadHandle:
    """One scheduled checkpoint swap (``ComputeEngine.request_reload``).
    ``event`` is set once the engine applied the swap, before the next
    request it serves, or failed it (``error``; the old params keep
    serving). The cpu-mp ingress sets ``engine_id`` and ``gen`` so that a
    handle of an engine process that died before its ACK can be resolved."""

    __slots__ = ("path", "event", "error", "engine_id", "gen")

    def __init__(self, path: str):
        self.path = path
        self.event = threading.Event()
        self.error: Exception | None = None
        self.engine_id: int | None = None
        self.gen: int | None = None


def pick_bucket(buckets, batch_size: int) -> int:
    """Smallest bucket >= batch_size in the ascending ``buckets``; the last
    bucket caps."""
    return next((b for b in buckets if b >= batch_size), buckets[-1])


class _Slot:
    """Host buffers of one in-flight execution, at the largest bucket: a
    payload group's assembled rows, with ``hotcold`` the host split of its
    lookups (flat, room for every lookup and the largest cold rung), and the
    landing place of its scores. Pinned on a card, so that every copy runs
    asynchronously."""

    def __init__(self, rows: int, cfg: ModelConfig, masked: bool, pin: bool,
                 hotcold: bool = False, mesh=None):
        T, L = cfg.num_tables, cfg.num_indices_per_lookup

        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.indices = buf((rows, T, L), torch.int32)
        self.dense = buf((rows, cfg.dense_dim), torch.float32) if cfg.dense_dim else None
        self.mask = buf((rows, T, L), torch.bool) if masked else None
        self.out = buf((rows, cfg.out_dim), compute_dtype_of(cfg))
        self.split = self.split_np = None
        if hotcold:
            n = rows * T * L
            cold_top = max(cold_buckets_for(n, mesh))
            if mesh is None:  # the splitter writes the unpadded stream here too
                cold, key = max(n, cold_top), "cold_ids"
            else:  # a stream a (data, model) cell
                cold, key = mesh.size * cold_top, "cold_local"
            self.split = {"hot_sel": buf((n,), torch.int32), "hot_mask": buf((n,), torch.bool),
                          key: buf((cold,), torch.int32), "cold_seg": buf((cold,), torch.int32)}
            self.split_np = {k: v.numpy() for k, v in self.split.items()}

    def stage(self, split: dict):
        """Copy ``split``'s arrays into the slot's buffers (a mesh split,
        which the splitters return in arrays of their own)."""
        for k, buf in self.split_np.items():
            v = split[k]
            buf[:v.size] = v.reshape(-1)

    def split_tensors(self, split: dict) -> dict:
        """The slot's buffers holding ``split`` (``prepare``'s result written
        into ``split_np``, or ``stage``d there), shaped as the split's
        arrays: as K6 takes them on one device."""
        return {k: buf[:split[k].size].view(split[k].shape) for k, buf in self.split.items()}


class ComputeEngine(threading.Thread):
    """An inference engine on the CUDA card (or on the CPU)."""

    def __init__(
        self,
        engine_id: int,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        request_q: "queue.Queue",
        response_q: "queue.Queue",
        ready_q: "queue.Queue",
        device=None,
        params=None,
        seed: int = 0,
        mesh=None,
        buckets=None,
        strict_buckets: bool = True,
        control_q=None,
        arena=None,
    ):
        super().__init__(name=f"engine-{engine_id}", daemon=True)
        self.engine_id = engine_id
        self.model_cfg = model_cfg
        self.serving_cfg = serving_cfg
        self.request_q = request_q
        self.response_q = response_q
        self.ready_q = ready_q
        # Raises when a card is asked for and there is none: never the CPU.
        # On a mesh the engine's device is its first entry (JAX engine.py:785).
        self.mesh = mesh
        if mesh is not None:
            mesh.require_one_process("ComputeEngine(mesh=)")
            device = mesh.devices.flat[0]
            for dev in mesh.distinct_devices:
                resolve_device(str(dev))
        self.device = resolve_device("cuda" if device is None else str(device))
        if self.device.type == "cuda" and self.device.index is None:
            # The card by its index, as tensors name it (streams are keyed so).
            self.device = torch.device("cuda", torch.cuda.current_device())
        # Why the programs stay eager (a mesh across processes), or None
        # where a card captures them: decided here, never by a failed capture.
        self.eager_reason = eager_reason(mesh)
        self.params = params
        self.seed = seed
        if buckets is None:
            from deeprecsys_tpu_torch.serving.buckets import resolve_buckets

            buckets = resolve_buckets(serving_cfg)
        self.buckets = tuple(
            b for b in sorted(buckets) if b <= serving_cfg.max_mini_batch_size
        ) or (serving_cfg.max_mini_batch_size,)
        if mesh is not None:
            # Every bucket divides the data axis: rounded up, so that a
            # request of the largest size is never served at a smaller cap
            # (the cap may pass max_mini_batch_size by under D pad rows).
            n_data = mesh.shape["data"]
            self.buckets = tuple(sorted({-(-b // n_data) * n_data for b in self.buckets}))
        self.model = None
        self._plan = None  # the mesh forward's parts by card (parallel.sharding.card_plan)
        self._rows = np.asarray(model_cfg.scaled_rows, np.int64)[None, :, None]
        self._host_data: dict[int, Batch] = {}  # bucket -> host rows (pinned on a card)
        self._pending: "queue.Queue" = queue.Queue()
        self._free_slots: "queue.Queue" = queue.Queue()
        self._streams: dict = {}  # device -> the engine's stream there (a card)
        self.error: Exception | None = None
        # Observability, single writer each: executions per bucket, warm-up
        # executions, coalesced, clamped, rejected and expired requests.
        self.bucket_counts: dict[int, int] = {}
        self.warmup_executions = 0
        # The serve-time programs: their static inputs, the set serving now,
        # and the captures made (with their wall ms) and the graph pool of
        # the current set (a card).
        self._static: StaticInputs | None = None
        self._static_at: dict = {}  # a mesh's place -> the static inputs on its card
        self.programs: ProgramSet | None = None
        self.graph_captures = 0
        self.capture_ms = 0.0
        self.graph_pool_bytes = None
        self.graph_pool_bytes_by_card: dict = {}
        self.coalesced_requests = 0
        self.clamped_requests = 0
        # Over-ladder handling: strict (the default for direct construction)
        # answers ERR_OVER_LADDER instead of undercomputing at the cap
        # bucket; serving pools pass False and count the clamp.
        self.strict_buckets = strict_buckets
        self.rejected_requests = 0   # strict over-ladder and payload rejections
        self.expired_requests = 0    # deadline-expired, dropped before dispatch
        self._clamp_warned = False
        # Hot/cold serving: the HotColdModel when the split is set up, the
        # sampled coverage of its hot set (hotcold/auto), and the refresh
        # state, all written by the serve thread only.
        self._hotcold = None
        self.hot_coverage = None
        self.hot_refreshes = 0
        self.live_hot_coverage = None
        self._live_hot = 0
        self._live_total = 0
        self._refresh_buf = None
        self._tracked_since_check = 0
        # A refresh that finds the stream headless disables the split and
        # serves the direct lookup, still watching the stream.
        self._hotcold_active = True
        self._upgrade_backoff = 0  # doubling skip count after failed scans
        self._upgrade_wait = 0
        # The scan worker computes candidate hot sets off the serve thread;
        # one task in flight, its result applied on the serve thread.
        self._scan_thread = None
        self._scan_req: "queue.Queue" = queue.Queue(maxsize=1)
        self._scan_res: "queue.Queue" = queue.Queue(maxsize=1)
        self._scan_inflight = False
        # Checkpoint reload: the pending handle, set under the lock; _stopped
        # (under the same lock) fails any handle asked of an exited engine.
        self._reload: ReloadHandle | None = None
        self._reload_lock = threading.Lock()
        self._stopped = False
        self.last_reload_ms = None  # wall time of the last applied swap
        # cpu-mp: the engine's reload control ring (path fragments, joined
        # a gen at a time) and the blob arena its payloads cross.
        self.control_q = control_q
        self.arena = arena
        self._reload_frags: dict[int, list] = {}

    # -- setup ---------------------------------------------------------

    def _setup(self):
        """Model, params (with ``hotcold``/``auto`` the hot set and its
        table; on a mesh sharded), the pinned rows of every bucket and the
        staging slots, then the programs (``_build_programs``). Runs in the
        engine's thread, on its stream."""
        cfg = self.model_cfg
        # The direct model: the lookup "auto" falls back to and a disabled
        # split serves; a hot/cold engine runs its tail (apply_from_pooled).
        self.model = get_model(cfg.replace(embedding_impl="xla"), self.device)
        if self.params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = self.model.init(gen)
        else:
            self.params = bridge.tree_map(lambda t: t.to(self.device), self.params)
        if cfg.embedding_impl in ("hotcold", "auto"):
            self._setup_hotcold(require=cfg.embedding_impl == "hotcold")
        if self.mesh is not None:
            from deeprecsys_tpu_torch.parallel import sharding

            # The table row-sharded over "model"; a hot table and the towers
            # replicated (JAX engine.py:279-290, :371-378).
            self.params = sharding.shard_params(self.params, self.mesh)
            self._plan = sharding.card_plan(self.mesh,
                                            sharded=self.params.rows_per_shard is not None)
        if self.device.type == "cuda":
            # Params and offsets were made on other streams or threads. A
            # device-wide wait must not meet another engine's capture.
            with BUILD_LOCK:
                for dev in self._devices():
                    torch.cuda.synchronize(dev)
        pin = self.device.type == "cuda"
        full = RecDataGenerator(cfg, seed=self.seed + 17,
                                data_generation=self.serving_cfg.data_generation,
                                trace_file=self.serving_cfg.synthetic_trace_file,
                                raw_data_file=self.serving_cfg.raw_data_file
                                ).generate_batch(max(self.buckets))

        def host(a):
            if a is None:
                return None
            t = torch.from_numpy(a)
            return t.pin_memory() if pin else t

        dense, indices = host(full.dense), host(full.indices)
        ragged = self.serving_cfg.accept_ragged
        hotcold = self._hotcold is not None
        for _ in range(IN_FLIGHT):
            self._free_slots.put(_Slot(max(self.buckets), cfg, ragged, pin, hotcold, self.mesh))
        for b in self.buckets:
            self._host_data[b] = Batch(dense=None if dense is None else dense[:b],
                                       indices=indices[:b])
        self._static = StaticInputs(cfg, max(self.buckets), ragged, hotcold, self.device,
                                    self.mesh)
        if self._plan is not None:  # the home card's (the last part's) are ``_static``
            home = self._plan[-1].place
            for p in self._plan:
                if p.place not in self._static_at:
                    self._static_at[p.place] = self._static if p.place == home else StaticInputs(
                        cfg, max(self.buckets), ragged, hotcold, p.device, self.mesh)
        self.programs = self._build_programs()

    def _program_keys(self) -> list:
        """The serve-time programs, in the JAX engine's warm order (its
        ``engine.py:296-324, :384-475, :525-542``): for each bucket a
        hot/cold program at each cold rung (a hot/cold engine; on a mesh the
        rungs a cell's stream pads to, ``:414-430``), then where
        the direct lookup serves (no split, or refresh tracking, which may
        disable the split) the direct program and, with ``accept_ragged``,
        its masked twin."""
        T, L = self.model_cfg.num_tables, self.model_cfg.num_indices_per_lookup
        hotcold = self._hotcold is not None
        direct = not hotcold or self.serving_cfg.hotcold_refresh_interval > 0
        keys = []
        for b in self.buckets:
            if hotcold:
                keys += [("hotcold", b, c_pad)
                         for c_pad in cold_buckets_for(b * T * L, self.mesh)]
            if direct:
                keys.append(("direct", b))
                if self.serving_cfg.accept_ragged:
                    keys.append(("masked", b))
        return keys

    def _build_programs(self) -> ProgramSet:
        """Build every program against the current params and hot set, each
        warmed on ``warm_inputs`` (on a card also captured and replayed once,
        one engine's set at a time in the process, unless ``eager_reason``);
        the warm-up executions and captures are counted."""
        progs = ProgramSet(self.device, capture=self.eager_reason is None,
                           devices=self._devices())
        on_card = self.device.type == "cuda"
        splits: dict = {}  # bucket -> its rows' split, for every cold rung
        with BUILD_LOCK if on_card else contextlib.nullcontext():
            for key in self._program_keys():
                stages, inputs, loads = self._program(key)
                progs.add(key, stages, inputs, self.warm_inputs(key, splits), loads)
            by_card = progs.pool_bytes_by_card()
        self.warmup_executions += progs.executions
        self.graph_captures += progs.captures
        self.capture_ms += progs.capture_ms
        self.graph_pool_bytes = sum(by_card.values()) if on_card else None
        self.graph_pool_bytes_by_card = by_card
        return progs

    def _inputs(self, key: tuple, static: StaticInputs) -> dict:
        """The slices of ``static`` program ``key`` reads."""
        if key[0] == "hotcold":
            return static.split_of(key[1], key[2])
        return static.rows(key[1], masked=key[0] == "masked")

    def _program(self, key: tuple) -> tuple:
        """Program ``key``'s ``(stages, inputs, loads)``, closed over the
        current params: on one device one stage, the forward of
        ``_forward``, whose inputs load whole (``loads`` None); on a mesh the
        stages of ``parallel.sharding.mesh_stages`` (one a card and job),
        each over the static inputs of its card, and the pieces of the host
        rows each card's slices take."""
        from deeprecsys_tpu_torch.parallel.sharding import Stage, mesh_stages

        if self.mesh is None:
            inputs = self._inputs(key, self._static)
            forward = self._forward(key[0])
            return [Stage(self.device, lambda recv: {"out": forward(inputs)}, {})], inputs, None
        at = {place: self._inputs(key, s) for place, s in self._static_at.items()}
        stages, pieces = mesh_stages(self.model, self.params, self._plan, at,
                                     hotcold=key[0] == "hotcold")
        loads = [(at[place][name][index] if index else at[place][name], name, index)
                 for place, name, index in pieces]
        return stages, at[self._plan[-1].place], loads

    def _forward(self, kind: str):
        """A program's forward over its static inputs on one device, closed
        over the current params: K6 on the split and the model's tail
        (``hotcold``), else the direct model (a hot/cold engine's without
        its hot table)."""
        params = self.params
        if kind == "hotcold":
            apply = self._hotcold.apply

            def forward(inp: dict) -> torch.Tensor:
                split = {k: v for k, v in inp.items() if k != "dense"}
                return apply(params, Batch(dense=inp.get("dense"), indices=None), split)
            return forward
        direct = params if self._hotcold is None else {
            k: v for k, v in params.items() if k != "hot_table"}
        apply = self.model.apply

        def forward(inp: dict) -> torch.Tensor:
            return apply(direct, Batch(dense=inp.get("dense"), indices=inp["indices"],
                                       mask=inp.get("mask")))
        return forward

    def warm_inputs(self, key: tuple, splits: dict | None = None) -> dict:
        """The host rows program ``key`` is warmed on (and on a card first
        replayed on), by input name: the bucket's pre-generated rows, an
        all-true mask for a masked twin, and for a hot/cold program their
        split by the current hot set with its cold stream cut or padded to
        the program's rung (``pad_cold``; on a mesh the mesh splitter's, each
        cell's stream): a split the splitter could give there, so every rung
        is warmed on real rows (JAX's warm-up pools an empty split).
        ``splits``: a dict the caller keeps, bucket -> the unpadded split, so
        that one split serves every rung."""

        b = key[1]
        host = self._host_data[b]
        rows = {"indices": host.indices}
        if host.dense is not None:
            rows["dense"] = host.dense
        if key[0] == "masked":
            rows["mask"] = torch.ones(host.indices.shape, dtype=torch.bool)
        elif key[0] == "hotcold":
            splits = {} if splits is None else splits
            if b not in splits:
                splits[b] = self._warm_split(host.indices.numpy())
            D = 1 if self.mesh is None else self.mesh.shape["data"]
            rows.update((k, torch.from_numpy(v)) for k, v in
                        pad_cold(splits[b], key[2], b // D * self.model_cfg.num_tables).items())
        return rows

    def _warm_split(self, idx: np.ndarray) -> dict:
        """``idx``'s split by the current hot set, unpadded (a mesh split:
        each cell padded to the largest), by the numpy splitter: the native
        splitter's calls stay the served executions'."""
        from deeprecsys_tpu_torch.ops.hotcold import (
            split_hot_cold, split_hot_cold_hybrid, split_hot_cold_sharded)

        offsets = np.asarray(self.model_cfg.table_offsets, np.int64)
        hot = np.asarray(self._hotcold.hot_ids)
        if self.mesh is None:
            return split_hot_cold(idx, offsets, hot, impl="numpy", pad=False)
        D, M = self.mesh.shape["data"], self.mesh.shape["model"]
        rps = self.model_cfg.total_rows // M
        if D == 1:
            return split_hot_cold_sharded(idx, offsets, hot, M, rps, impl="numpy")
        return split_hot_cold_hybrid(idx, offsets, hot, D, M, rps, impl="numpy")

    def _swap_programs(self, params):
        """Serve ``params`` (a dict, or on a mesh ``ShardedParams``): build
        the programs against them, then drop the old programs and params
        once the executions queued on the engine's streams, which read both,
        are done. A failed build keeps the old ones serving."""
        old = self.params, self.programs
        self.params = params
        try:
            self.programs = self._build_programs()
        except BaseException:
            self.params, self.programs = old
            raise
        for stream in self._streams.values():
            stream.synchronize()
        del old

    def _devices(self) -> list:
        """The devices the engine runs on: the mesh's distinct ones, or its one."""
        return [self.device] if self.mesh is None else self.mesh.distinct_devices

    def _setup_hotcold(self, require: bool):
        """The hot/cold split (JAX ``engine.py:326-380``): the hot set,
        sized by ``hot_set_rows`` (0: ``suggest_hot_rows``), chosen from
        the engine's own data stream with its out-of-sample coverage. With
        ``require=False`` (``auto``) a table under ``hotcold_min_table_mb``
        is not sampled, and a coverage under ``hotcold_min_hit`` keeps the
        direct lookup. The params gain the hot table."""
        from deeprecsys_tpu_torch.models.hotcold import (
            hot_ids_and_coverage_from_generator, make_hotcold_model)
        from deeprecsys_tpu_torch.utils.memory import suggest_hot_rows

        cfg = self.model_cfg
        if not require and cfg.fused_table_mb < cfg.hotcold_min_table_mb:
            return  # the size floor: a small table's direct lookup stays
        hot_rows = cfg.hot_set_rows if cfg.hot_set_rows > 0 else suggest_hot_rows(cfg)
        # The warm-up sample grows with the hot budget, so a large budget is
        # filled from the stream and not limited by the sample.
        T, L = cfg.num_tables, cfg.num_indices_per_lookup
        n_batches = int(np.clip(-(-4 * hot_rows // (256 * T * L)), 8, 256))
        hot_ids, coverage = hot_ids_and_coverage_from_generator(
            cfg, seed=self.seed + 31, hot_rows=hot_rows, n_batches=n_batches,
            data_generation=self.serving_cfg.data_generation,
            trace_file=self.serving_cfg.synthetic_trace_file,
            raw_data_file=self.serving_cfg.raw_data_file)
        self.hot_coverage = coverage
        if not require and coverage < cfg.hotcold_min_hit:
            return
        self._hotcold = make_hotcold_model(self.model, hot_ids, mesh=self.mesh)
        self.params = self._hotcold.convert_params(self.params)

    def _payload_ok(self, r: ServiceRequest) -> bool:
        """True iff a request's payload (if any) matches the model's inputs
        (indices (batch_size, T, L) of integers in [0, rows[t]), dense
        present iff the model takes dense features, a mask only on an
        ``accept_ragged`` engine and shaped like the indices)."""
        p = r.payload
        if p is None:
            return True
        base = self._host_data[self.buckets[0]]
        T, L = base.indices.shape[1:]
        idx = p.indices
        if getattr(idx, "shape", None) != (r.batch_size, T, L):
            return False
        idx = np.asarray(idx)
        if not np.issubdtype(idx.dtype, np.integer) or (
                idx.size and (idx.min() < 0 or (idx >= self._rows).any())):
            return False  # K1 would read another table's row or past the table
        if (base.dense is None) != (p.dense is None):
            return False
        if p.dense is not None and p.dense.shape != (r.batch_size, base.dense.shape[1]):
            return False
        if p.mask is not None:
            if not self.serving_cfg.accept_ragged:
                return False
            if p.mask.shape != (r.batch_size, T, L):
                return False
        return True

    def _assemble_host(self, group, bucket: int, slot: _Slot) -> Batch:
        """Bucket-size host rows for a group that holds client payloads,
        written into ``slot``: each request's rows at its cumulative offset
        (the completion thread slices scores at the same offsets); requests
        without a payload and the pad up to ``bucket`` take the
        pre-generated rows at the same positions. A masked member gives the
        whole execution a mask, all-true for the other rows."""
        base = self._host_data[bucket]
        any_mask = any(r.payload is not None and r.payload.mask is not None
                       for r in group)
        idx = slot.indices[:bucket].numpy()
        dense = None if slot.dense is None else slot.dense[:bucket].numpy()
        mask = slot.mask[:bucket].numpy() if any_mask else None
        base_idx = base.indices.numpy()
        base_dense = None if base.dense is None else base.dense.numpy()
        off = 0
        for r in group:
            end = off + r.batch_size
            p = r.payload
            idx[off:end] = base_idx[off:end] if p is None else p.indices
            if dense is not None:
                dense[off:end] = base_dense[off:end] if p is None else p.dense
            if mask is not None:
                mask[off:end] = True if p is None or p.mask is None else p.mask
            off = end
        if off < bucket:  # pad to the bucket
            idx[off:] = base_idx[off:bucket]
            if dense is not None:
                dense[off:] = base_dense[off:bucket]
            if mask is not None:
                mask[off:] = True
        return Batch(dense=None if dense is None else slot.dense[:bucket],
                     indices=slot.indices[:bucket],
                     mask=slot.mask[:bucket] if any_mask else None)

    def _dispatch(self, host: Batch, bucket: int, slot: _Slot, split: dict | None = None) -> list:
        """Run one execution of ``host`` (and ``split``, the host split held
        in ``slot``) and copy the scores into ``slot``: its program (K6 on
        the split, else the direct lookup, masked if ``host`` is) copies the
        rows in and replays (on the CPU runs its forward).
        Returns the events that mark the scores readable, one on the
        engine's stream of each of its devices (none on the CPU, where every
        step is synchronous)."""
        on_card = self.device.type == "cuda"
        if split is not None:
            # The split stands for the ids and consumed the ragged mask: the
            # program takes the split and the dense features.
            rows = slot.split_tensors(split)
            rows["dense"] = host.dense
            c_pad = split[self._static.cold_key].shape[-1]
            out = self.programs[("hotcold", bucket, c_pad)].run(rows)
        else:
            rows = {"dense": host.dense, "indices": host.indices, "mask": host.mask}
            out = self.programs[("direct" if host.mask is None else "masked", bucket)].run(rows)
        slot.out[:bucket].copy_(out, non_blocking=on_card)
        if not on_card:
            return []
        events = []
        for stream in self._streams.values():
            event = torch.cuda.Event()
            event.record(stream)
            events.append(event)
        return events

    # -- run loop ------------------------------------------------------

    def run(self):
        with contextlib.ExitStack() as stack:
            try:
                stack.enter_context(torch.inference_mode())
                if self.device.type == "cuda":
                    # A stream on each of the engine's devices, current in
                    # this thread; then the engine's own device is current.
                    for dev in self._devices():
                        self._streams[dev] = torch.cuda.Stream(dev)
                        stack.enter_context(torch.cuda.stream(self._streams[dev]))
                    stack.enter_context(torch.cuda.device(self.device))
                self._setup()
            except Exception as e:  # surface engine failures instead of hanging
                self.error = e
                self.ready_q.put(e)
                self._stop_and_release_reload("engine failed during setup")
                self.response_q.put(_SENTINEL)
                return
            self.ready_q.put(self.engine_id)

            completer = threading.Thread(target=self._completion_loop,
                                         name=f"engine-{self.engine_id}-completion",
                                         daemon=True)
            completer.start()
            try:
                self._serve_loop()
            except Exception as e:
                # A mid-run crash must not deadlock the fabric: record it,
                # then sink requests until the shutdown sentinel so the load
                # generator can finish; the dropped requests show as lost.
                self.error = e
                print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} "
                      f"crashed mid-run ({e!r}); sinking its queue until "
                      f"shutdown", flush=True)
                self._sink_requests()
            self._pending.put(_SENTINEL)
            completer.join()
        if self._scan_thread is not None:
            # Best-effort stop: with a task in flight the daemon worker ends
            # with the process after its scan.
            try:
                self._scan_req.put_nowait(None)
            except queue.Full:
                pass
        self._stop_and_release_reload("engine shut down before applying the reload")
        self.response_q.put(_SENTINEL)

    def _sink_requests(self):
        while self.request_q.get() is not _SENTINEL:
            pass

    def _emit_error(self, request: ServiceRequest, code: int, t: float):
        """Answer one request with an error response; no device time spent."""
        now = time.time()
        self.response_q.put(ServiceResponse(
            consumer_id=self.engine_id,
            epoch=request.epoch,
            batch_id=request.batch_id,
            batch_size=request.batch_size,
            arrival_time=request.arrival_time,
            queue_start_time=t,
            queue_end_time=now,
            inference_end_time=now,
            out_batch_size=0,
            sub_id=request.sub_id,
            total_sub_batches=request.total_sub_batches,
            exp_packet=request.exp_packet,
            error_code=code,
        ))

    # -- checkpoint reload (JAX engine.py:732-804) -------------------------

    def request_reload(self, path: str) -> ReloadHandle:
        """Schedule a swap to the checkpoint at ``path`` (the model's params
        in the JAX package's format, ``utils/checkpoint.py``). Applied
        before the next request this engine serves; a newer request
        supersedes a pending one, whose handle is failed so that no waiter
        hangs. Thread-safe."""
        handle = ReloadHandle(path)
        with self._reload_lock:
            if self._stopped:
                handle.error = RuntimeError("engine has shut down")
                handle.event.set()
                return handle
            prev, self._reload = self._reload, handle
        if prev is not None and not prev.event.is_set():
            prev.error = RuntimeError(f"superseded by a newer reload request ({path})")
            prev.event.set()
        return handle

    def _stop_and_release_reload(self, msg: str):
        """Mark the engine stopped and fail a pending reload, in one locked
        section, so that no handle is parked after the last take."""
        with self._reload_lock:
            self._stopped = True
            pending, self._reload = self._reload, None
        if pending is not None:
            pending.error = RuntimeError(msg)
            pending.event.set()

    def _take_pending_reload(self) -> ReloadHandle | None:
        with self._reload_lock:
            pending, self._reload = self._reload, None
        return pending

    def _apply_reload(self, handle: ReloadHandle):
        """Load ``handle.path`` and swap it in (serve thread, so on the
        engine's stream): the direct model's layout (float, per-table or
        row-wise int8) fixes the template, and a hot/cold engine adds the
        hot table gathered from the new tables."""
        from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

        t0 = time.perf_counter()
        try:
            new = checkpoint_params(self.model_cfg.replace(embedding_impl="xla"),
                                    handle.path, self.device)
            if self._hotcold is not None:
                new = self._hotcold.convert_params(new)
            if self.mesh is not None:
                from deeprecsys_tpu_torch.parallel import shard_params

                new = shard_params(new, self.mesh)  # JAX engine.py:785-792
            # The programs captured against the old params: rebuilt.
            self._swap_programs(new)
            self.last_reload_ms = (time.perf_counter() - t0) * 1000.0
        except Exception as e:
            handle.error = e
        finally:
            handle.event.set()

    def _poll_control(self):
        """cpu-mp: drain the control ring, join each gen's path fragments
        in order, apply each complete path and ACK it on the response ring
        with the gen in ``sub_id`` (JAX ``engine.py:1195-1242``)."""
        if self.control_q is None:
            return
        while True:
            try:
                frag = self.control_q.get_nowait()
            except queue.Empty:
                return
            if frag is None:
                continue
            buf = self._reload_frags.setdefault(frag.gen, [])
            if frag.seq != len(buf):
                # A torn sequence (its sender died mid-path): drop it; a
                # fresh seq 0 starts over.
                print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} dropped a "
                      f"torn reload-path sequence (gen {frag.gen}, got seq {frag.seq} "
                      f"after {len(buf)} fragments)", flush=True)
                self._reload_frags.pop(frag.gen, None)
                if frag.seq != 0:
                    continue
                buf = self._reload_frags.setdefault(frag.gen, [])
            buf.append(frag)
            if len(buf) < frag.total:
                continue
            del self._reload_frags[frag.gen]
            handle = ReloadHandle(b"".join(f.payload for f in buf).decode())
            self._apply_reload(handle)
            now = time.time()
            failed = handle.error is not None
            self.response_q.put(ServiceResponse(
                consumer_id=self.engine_id, epoch=0, batch_id=RELOAD_ACK_BATCH_ID,
                batch_size=0, arrival_time=now, queue_start_time=now, queue_end_time=now,
                inference_end_time=now, out_batch_size=0 if failed else 1,
                sub_id=frag.gen, total_sub_batches=1, exp_packet=True,
                error_code=ERR_RELOAD if failed else 0))
            if failed:
                print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} reload of "
                      f"{handle.path!r} failed ({handle.error!r}); previous params keep "
                      f"serving", flush=True)

    def _next_request(self):
        """The next request, waking every 0.5 s while idle to apply a
        pending reload (a thread engine's handle, a process engine's
        control ring), so that an idle engine does not hold a swap back."""
        if not isinstance(self.request_q, queue.Queue) and self.control_q is None:
            return self.request_q.get()
        while True:
            try:
                return self.request_q.get(timeout=0.5)
            except queue.Empty:
                self._poll_control()
                pending = self._take_pending_reload()
                if pending is not None:
                    self._apply_reload(pending)

    def _hydrate(self, request):
        """cpu-mp: the features of a request that names a blob-arena slot,
        copied out of the slot (its scores go back into it). An unreadable
        slot is answered ERR_READBACK and gives ``_DROPPED``."""
        if (request is _SENTINEL or self.arena is None or request.payload is not None
                or request.payload_slot < 0):
            return request
        try:
            idx, dense, mask = self.arena.read_batch(request.payload_slot)
        except Exception as e:
            print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} failed to read "
                  f"payload slot {request.payload_slot} ({e!r}); answering ERR_READBACK",
                  flush=True)
            self._emit_error(request, ERR_READBACK, time.time())
            return _DROPPED
        request.payload = Batch(dense=dense, indices=idx, mask=mask)
        return request

    # -- hot/cold dispatch and refresh (JAX engine.py:806-1194) ---------

    def _split(self, host: Batch, slot: _Slot, real_rows: int) -> dict | None:
        """The host split of ``host`` written into ``slot``, or None where
        the execution takes the direct lookup (no split set up, or the split
        disabled). With refresh tracking the first ``real_rows`` rows (the
        requests' own; the rest of the bucket is pad) feed the tracker, which
        may swap the hot set or disable the split before this dispatch."""
        if self._hotcold is None:
            return None
        tracking = self.serving_cfg.hotcold_refresh_interval > 0
        if not self._hotcold_active:
            if tracking:
                self._track_direct(host, real_rows)
            return None
        split = self._prepare(host, slot)
        if tracking and self._track_hotcold(host, split, real_rows):
            if not self._hotcold_active:
                return None
            split = self._prepare(host, slot)  # against the new set
        return split

    def _prepare(self, host: Batch, slot: _Slot) -> dict:
        """The host split of ``host`` in ``slot``'s buffers: written there by
        the splitter on one device, copied there from a mesh split."""
        if self.mesh is None:
            return self._hotcold.prepare(host, out=slot.split_np)
        split = self._hotcold.prepare(host)
        slot.stage(split)
        return split

    def _track_hotcold(self, host: Batch, split: dict, real_rows: int) -> bool:
        """Adaptive hot-set refresh: accumulate the live hit rate from the
        split's hot mask and buffer the requests' rows; every
        ``hotcold_refresh_interval`` tracked executions, scan for a better
        hot set when the windowed coverage fell ``hotcold_refresh_margin``
        below the reference (a refresh), or when the reference itself is
        under ``hotcold_min_hit`` (an upgrade, backing off after failed
        scans). Returns True when the hot set or the split's state changed
        (the caller's split is stale). Serve thread only."""
        cfg = self.serving_cfg
        hm = np.asarray(split["hot_mask"])[:real_rows]
        self._live_hot += int(hm.sum())
        if host.mask is None:
            self._live_total += int(hm.size)
        else:
            # The split zeroed hot_mask on invalid slots: only valid slots
            # are lookups.
            self._live_total += int(np.asarray(host.mask[:real_rows]).sum())
        if self._refresh_buf is None:
            self._refresh_buf = collections.deque(maxlen=max(cfg.hotcold_refresh_window, 1))
        self._refresh_buf.append(self._buffered(host, real_rows))
        # A finished worker scan applies on the next tracked execution.
        changed = self._apply_scan_result()
        self._tracked_since_check += 1
        if self._tracked_since_check < cfg.hotcold_refresh_interval:
            return changed
        cov = self._live_hot / max(self._live_total, 1)
        self.live_hot_coverage = cov
        self._tracked_since_check = 0
        self._live_hot = self._live_total = 0
        ref = self.hot_coverage if self.hot_coverage is not None else 0.0
        if cov >= ref - cfg.hotcold_refresh_margin:
            # No degradation; a set that was never good is upgraded when a
            # set from the live stream would cover more.
            if ref >= self.model_cfg.hotcold_min_hit:
                return changed
            if self._upgrade_wait > 0:
                self._upgrade_wait -= 1
                return changed
            res = self._scan("upgrade", cov)
            if res is not None:  # sync mode: decided inline
                changed = self._apply_upgrade(res, cov) or changed
            return changed
        res = self._scan("refresh", cov)
        if res is not None:
            changed = self._apply_refresh(res, cov) or changed
        return changed

    def _scan(self, kind: str, cov):
        """Ask for a candidate scan. Sync (``hotcold_scan_async=False``):
        computed inline, returns (new_hot, est_coverage). Async: a snapshot
        of the buffer goes to the worker (one task in flight) and None
        comes back; the result applies on a later tracked execution."""
        if not self.serving_cfg.hotcold_scan_async:
            return self._candidate_hot_ids()
        if not self._scan_inflight:
            old_hot = None if self._hotcold is None else np.asarray(self._hotcold.hot_ids)
            k = 0 if old_hot is None else len(old_hot)
            if self._scan_thread is None:
                self._scan_thread = threading.Thread(
                    target=self._scan_worker_loop, daemon=True,
                    name=f"engine-{self.engine_id}-scan")
                self._scan_thread.start()
            self._scan_inflight = True
            self._scan_req.put((kind, cov, list(self._refresh_buf), k, old_hot))
        return None

    def _scan_worker_loop(self):
        """The scan worker: candidate ids and their HotIndex, host work
        only (it launches nothing on the card)."""
        while True:
            task = self._scan_req.get()
            if task is None:
                return
            kind, cov, batches, k, old_hot = task
            try:
                res = self._candidate_hot_ids_from(batches, k, old_hot)
            except Exception as e:  # never kill the worker silently
                print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} scan worker "
                      f"failed ({e!r}); scan dropped", flush=True)
                res = (None, None)
            hot_index = None
            if res[0] is not None:
                try:
                    from deeprecsys_tpu_torch.runtime.native import HotIndex

                    hot_index = HotIndex(res[0])
                except RuntimeError:
                    pass
            self._scan_res.put((kind, cov, res, hot_index))

    def _apply_scan_result(self) -> bool:
        """Apply a finished worker scan (serve thread). Returns True when
        the split's state changed."""
        try:
            kind, cov, res, hot_index = self._scan_res.get_nowait()
        except queue.Empty:
            return False
        self._scan_inflight = False
        if kind == "upgrade":
            changed = self._apply_upgrade(res, cov, hot_index=hot_index)
        elif kind == "refresh":
            changed = self._apply_refresh(res, cov, hot_index=hot_index)
        else:
            changed = self._apply_reenable(res, hot_index=hot_index)
        if changed:
            # Executions against the old set must not count in the new
            # set's window: restart it at the swap.
            self._live_hot = self._live_total = 0
            self._tracked_since_check = 0
        return changed

    def _apply_upgrade(self, res, cov: float, hot_index=None) -> bool:
        new_hot, cand = res
        cfg = self.serving_cfg
        ref = self.hot_coverage if self.hot_coverage is not None else 0.0
        if new_hot is None or cand is None or cand < max(ref, cov) + cfg.hotcold_refresh_margin:
            self._upgrade_backoff = min(max(self._upgrade_backoff, 1) * 2, 64)
            self._upgrade_wait = self._upgrade_backoff
            return False
        self._upgrade_backoff = self._upgrade_wait = 0
        self._install_hot_ids(new_hot, cand, hot_index=hot_index)
        print(f"[deeprecsys_tpu_torch] engine {self.engine_id}: hot-set UPGRADE "
              f"#{self.hot_refreshes} (live coverage {cov:.1%} -> candidate {cand:.1%})",
              flush=True)
        return True

    @staticmethod
    def _buffered(host: Batch, real_rows: int):
        """A refresh-buffer entry: copies of the requests' ids and mask (the
        staging slot they lie in is reused)."""
        return (np.array(host.indices[:real_rows]),
                None if host.mask is None else np.array(host.mask[:real_rows]))

    def _candidate_hot_ids(self):
        """(new_hot, est_coverage) from the buffered stream (sync mode)."""
        return self._candidate_hot_ids_from(list(self._refresh_buf),
                                            len(self._hotcold.hot_ids),
                                            np.asarray(self._hotcold.hot_ids))

    def _candidate_hot_ids_from(self, batches, k: int, old_hot):
        """A candidate hot set of ``k`` ids selected on the buffered batches
        but the last quarter (topped up to ``k`` with old ids still hot, so
        the hot table keeps its shape), and its coverage on that held-out
        quarter, both under ``hotcold_scan_budget``; (None, None) under two
        batches. Reads only its arguments: safe on the worker."""
        from deeprecsys_tpu_torch.ops.hotcold import (
            hot_coverage_of, scan_budget_subsample, select_hot_ids)

        if len(batches) < 2:
            return None, None
        offsets = np.asarray(self.model_cfg.table_offsets)
        n_hold = max(1, len(batches) // 4)

        def cat(entries):
            idx = np.concatenate([e[0] for e in entries], axis=0)
            if all(e[1] is None for e in entries):
                return idx, None
            mask = np.concatenate([np.ones(e[0].shape, dtype=bool) if e[1] is None else e[1]
                                   for e in entries], axis=0)
            return idx, mask

        budget = self.serving_cfg.hotcold_scan_budget
        sel_idx, sel_mask = cat(batches[:-n_hold])
        hold_idx, hold_mask = cat(batches[-n_hold:])
        select = scan_budget_subsample(sel_idx, budget)
        holdout = scan_budget_subsample(hold_idx, budget)
        if sel_mask is not None:
            sel_mask = scan_budget_subsample(sel_mask, budget)
        if hold_mask is not None:
            hold_mask = scan_budget_subsample(hold_mask, budget)
        new_hot = select_hot_ids(select, offsets, k, mask=sel_mask)
        if len(new_hot) < k:
            extra = np.setdiff1d(old_hot, new_hot)
            new_hot = np.sort(np.concatenate([new_hot, extra[:k - len(new_hot)]]))
        return new_hot, hot_coverage_of(holdout, offsets, new_hot, mask=hold_mask)

    def _apply_refresh(self, res, live_cov: float, hot_index=None) -> bool:
        """Live coverage fell: install the buffered stream's head, or,
        where no candidate reaches ``hotcold_min_hit``, disable the split.
        Returns True when the state changed."""
        new_hot, new_cov = res
        if new_cov is None:
            return False  # too few buffered batches to estimate
        if new_cov < self.model_cfg.hotcold_min_hit:
            self._disable_hotcold(live_cov, new_cov)
            return True
        self._install_hot_ids(new_hot, new_cov, hot_index=hot_index)
        print(f"[deeprecsys_tpu_torch] engine {self.engine_id}: hot-set refresh "
              f"#{self.hot_refreshes} (live coverage {live_cov:.1%} -> buffered-stream "
              f"coverage {new_cov:.1%}, {len(new_hot)} rows)", flush=True)
        return True

    def _install_hot_ids(self, new_hot, ref_cov: float, hot_index=None):
        """Swap in a hot set, and re-base the coverage reference on it: the
        new hot rows written into the hot table the programs read, on the
        engine's stream (executions queued before the write read the old
        rows, in stream order); a set of another size rebuilds the programs
        on a new table."""
        from deeprecsys_tpu_torch.models.hotcold import with_hot_ids

        hc = with_hot_ids(self._hotcold, new_hot, mesh=self.mesh, hot_index=hot_index)
        if len(new_hot) == len(self._hotcold.hot_ids):
            self._write_hot_rows(new_hot)
        else:
            prev, self._hotcold = self._hotcold, hc
            if self.mesh is None:
                new = hc.convert_params({k: v for k, v in self.params.items()
                                         if k != "hot_table"})
            else:
                from deeprecsys_tpu_torch.parallel.sharding import gather_rows

                new = self.params.with_leaf("hot_table", gather_rows(self.params, new_hot))
            try:
                self._swap_programs(new)
            except BaseException:
                self._hotcold = prev
                raise
        self._hotcold = hc
        self.hot_coverage = ref_cov
        self.hot_refreshes += 1

    def _write_hot_rows(self, new_hot):
        """The rows ``new_hot`` of the live table, in its layout, written
        into the engine's own hot table in place. On a mesh the rows are
        gathered from the shards that own them, as raw rows of the table's
        layout, and written into the hot table on each distinct device (JAX
        ``engine.py:1104-1113``)."""
        if self.mesh is not None:
            from deeprecsys_tpu_torch.parallel.sharding import gather_rows

            self.params.write_leaf("hot_table", gather_rows(self.params, new_hot))
            return
        tables = self.params["tables"]
        rows = tables if not isinstance(tables, dict) else tables.get("qrows", tables.get("q"))
        hid = torch.from_numpy(np.asarray(new_hot, dtype=np.int64))
        if self.device.type == "cuda":
            hid = hid.pin_memory().to(self.device, non_blocking=True)
        torch.index_select(rows, 0, hid, out=self.params["hot_table"])

    def _disable_hotcold(self, live_cov: float, cand_cov: float):
        self._hotcold_active = False
        self.hot_coverage = cand_cov
        print(f"[deeprecsys_tpu_torch] engine {self.engine_id}: hot/cold split DISABLED "
              f"(live coverage {live_cov:.1%}, best candidate {cand_cov:.1%} < min_hit "
              f"{self.model_cfg.hotcold_min_hit:.0%}); serving the direct lookup, still "
              f"watching the stream", flush=True)

    def _track_direct(self, host: Batch, real_rows: int):
        """The disabled split's watch: keep buffering, and every interval
        estimate what a new hot set would cover (host work only)."""
        self._refresh_buf.append(self._buffered(host, real_rows))
        self._apply_scan_result()
        self._tracked_since_check += 1
        if self._tracked_since_check < self.serving_cfg.hotcold_refresh_interval:
            return
        self._tracked_since_check = 0
        res = self._scan("reenable", None)
        if res is not None:  # sync mode
            self._apply_reenable(res)

    def _apply_reenable(self, res, hot_index=None) -> bool:
        new_hot, cov = res
        if cov is not None:
            self.live_hot_coverage = cov
        # Hysteresis: re-enable needs min_hit + margin.
        if cov is None or cov < (self.model_cfg.hotcold_min_hit
                                 + self.serving_cfg.hotcold_refresh_margin):
            return False
        self._install_hot_ids(new_hot, cov, hot_index=hot_index)
        self._hotcold_active = True
        self._live_hot = self._live_total = 0
        print(f"[deeprecsys_tpu_torch] engine {self.engine_id}: hot/cold split RE-ENABLED "
              f"(candidate coverage {cov:.1%}, refresh #{self.hot_refreshes})", flush=True)
        return True

    def _serve_loop(self):
        cfg = self.serving_cfg
        done = False
        carry = None  # request drained during coalescing that didn't fit
        while not done:
            request = carry if carry is not None else self._hydrate(self._next_request())
            carry = None
            if request is _SENTINEL:
                break
            if request is _DROPPED:
                continue
            group = [request]
            if cfg.coalesce_requests:
                # Dynamic batching: drain waiting requests into one bucket
                # execution. A drained request that would overflow the
                # largest bucket is carried into the next execution.
                total = request.batch_size
                while len(group) < cfg.max_coalesce and total < self.buckets[-1]:
                    try:
                        nxt = self.request_q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _SENTINEL:
                        # The sentinel belongs to whichever engine blocks on
                        # the queue next: put it back.
                        self.request_q.put(_SENTINEL)
                        done = True
                        break
                    nxt = self._hydrate(nxt)
                    if nxt is _DROPPED:
                        continue
                    if total + nxt.batch_size > self.buckets[-1]:
                        carry = nxt
                        break
                    group.append(nxt)
                    total += nxt.batch_size
            # A swap scheduled before any request of this group was taken
            # applies to the whole group.
            pending = self._take_pending_reload()
            if pending is not None:
                self._apply_reload(pending)
            self._poll_control()
            queue_start = time.time()
            # Deadline admission and payload checks, before any device work.
            live = []
            for r in group:
                if r.deadline and queue_start > r.deadline:
                    self.expired_requests += 1
                    self._emit_error(r, ERR_DEADLINE, queue_start)
                elif not self._payload_ok(r):
                    self.rejected_requests += 1
                    self._emit_error(r, ERR_PAYLOAD, queue_start)
                else:
                    live.append(r)
            group = live
            if not group:
                continue
            total_rows = sum(r.batch_size for r in group)
            bucket = pick_bucket(self.buckets, total_rows)
            if bucket < total_rows:
                if self.strict_buckets:
                    self.rejected_requests += len(group)
                    for r in group:
                        self._emit_error(r, ERR_OVER_LADDER, queue_start)
                    continue
                # Payload requests can never be clamped (their scores must
                # match their rows 1:1); only load-modeling members are.
                keep = []
                for r in group:
                    if r.payload is not None:
                        self.rejected_requests += 1
                        self._emit_error(r, ERR_OVER_LADDER, queue_start)
                    else:
                        keep.append(r)
                group = keep
                if not group:
                    continue
                self.clamped_requests += len(group)
                if not self._clamp_warned:
                    self._clamp_warned = True
                    print(f"[deeprecsys_tpu_torch] WARNING: engine "
                          f"{self.engine_id} clamped a {total_rows}-row "
                          f"request to its largest bucket {bucket}; extend "
                          f"batch_buckets or use bucket_policy=auto", flush=True)
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            if len(group) > 1:
                self.coalesced_requests += len(group)
            slot = self._free_slots.get()
            if any(r.payload is not None for r in group):
                host = self._assemble_host(group, bucket, slot)
            else:
                host = self._host_data[bucket]
            split = self._split(host, slot, min(sum(r.batch_size for r in group), bucket))
            events = self._dispatch(host, bucket, slot, split)
            queue_end = time.time()
            self._pending.put((group, slot, bucket, events, queue_start, queue_end))

    def _completion_loop(self):
        with torch.inference_mode():
            while True:
                item = self._pending.get()
                if item is _SENTINEL:
                    return
                self._complete(*item)

    def _complete(self, group, slot: _Slot, bucket: int, events: list, queue_start: float,
                  queue_end: float):
        # A response is complete when the client could read its scores (the
        # reference fetches the output blob, inferenceEngine.py:52-58): wait
        # for the copy back, the place where a device error surfaces.
        try:
            try:
                for e in events:
                    e.synchronize()
                scores = slot.out[:bucket].to(torch.float32, copy=True).numpy()
            finally:
                self._free_slots.put(slot)
        except Exception as e:
            if self.error is None:
                self.error = e
            print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} "
                  f"readback failed ({e!r}); answering {len(group)} "
                  f"request(s) with ERR_READBACK", flush=True)
            for request in group:
                self._emit_error(request, ERR_READBACK, queue_start)
            return
        end = time.time()
        off = 0  # cumulative row offset, as in _assemble_host
        for request in group:
            # A singleton owns the whole padded execution; coalesced members
            # report their own rows.
            out_rows = int(scores.shape[0]) if len(group) == 1 else request.batch_size
            own_scores = (scores[off:off + request.batch_size]
                          if request.payload is not None else None)
            off += request.batch_size
            if own_scores is not None and self.arena is not None and request.payload_slot >= 0:
                # cpu-mp: the scores go back through the request's slot,
                # written before the response is pushed.
                try:
                    self.arena.write_scores(request.payload_slot, own_scores)
                except Exception as e:
                    print(f"[deeprecsys_tpu_torch] WARNING: engine {self.engine_id} failed "
                          f"to write scores to slot {request.payload_slot} ({e!r})", flush=True)
                    self._emit_error(request, ERR_READBACK, queue_start)
                    continue
            self.response_q.put(ServiceResponse(
                consumer_id=self.engine_id,
                epoch=request.epoch,
                batch_id=request.batch_id,
                batch_size=request.batch_size,
                arrival_time=request.arrival_time,
                queue_start_time=queue_start,
                queue_end_time=queue_end,
                inference_end_time=end,
                out_batch_size=out_rows,
                sub_id=request.sub_id,
                total_sub_batches=request.total_sub_batches,
                exp_packet=request.exp_packet,
                scores=own_scores,
            ))


class SimEngine(threading.Thread):
    """Latency-model engine: sleeps instead of computing (reference
    ``accelInferenceEngine.py:44-84``); the serving tests' fake."""

    def __init__(
        self,
        engine_id: int,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        request_q: "queue.Queue",
        response_q: "queue.Queue",
        ready_q: "queue.Queue",
        latency_model: LatencyModel,
    ):
        super().__init__(name=f"sim-engine-{engine_id}", daemon=True)
        self.engine_id = engine_id
        self.request_q = request_q
        self.response_q = response_q
        self.ready_q = ready_q
        self.latency_model = latency_model
        self.expired_requests = 0

    def run(self):
        self.ready_q.put(self.engine_id)
        while True:
            request = self.request_q.get()
            if request is _SENTINEL:
                break
            queue_start = time.time()
            if request.deadline and queue_start > request.deadline:
                self.expired_requests += 1
                self.response_q.put(ServiceResponse(
                    consumer_id=self.engine_id, epoch=request.epoch,
                    batch_id=request.batch_id, batch_size=request.batch_size,
                    arrival_time=request.arrival_time,
                    queue_start_time=queue_start, queue_end_time=queue_start,
                    inference_end_time=queue_start, out_batch_size=0,
                    sub_id=request.sub_id,
                    total_sub_batches=request.total_sub_batches,
                    exp_packet=request.exp_packet, error_code=ERR_DEADLINE))
                continue
            # The full per-request latency, slept serially (the JAX package
            # measured this serial model as the faithful one).
            time.sleep(self.latency_model.predict_ms(request.batch_size) / 1000.0)
            now = time.time()
            self.response_q.put(ServiceResponse(
                consumer_id=self.engine_id,
                epoch=request.epoch,
                batch_id=request.batch_id,
                batch_size=request.batch_size,
                arrival_time=request.arrival_time,
                queue_start_time=queue_start,
                queue_end_time=now,
                inference_end_time=now,
                out_batch_size=request.batch_size,
                sub_id=request.sub_id,
                total_sub_batches=request.total_sub_batches,
                exp_packet=request.exp_packet,
            ))
        self.response_q.put(_SENTINEL)


def build_engine_pool(
    model_cfg,
    cfg,
    request_q,
    accel_request_q,
    response_q,
    ready_q,
    latency_model=None,
    accel_latency_model=None,
    params=None,
    mesh=None,
    id_base: int = 0,
    accel_device: str = "cuda",
):
    """The thread engines of a ServingConfig: ``cfg.inference_engines``
    engines on the backend's device ("gpu": the card, "cpu", or "sim":
    ``SimEngine``s over ``latency_model``), plus with ``model_accel`` one
    offload engine for whole big queries (a ``SimEngine`` over
    ``accel_latency_model`` if given, else a ``ComputeEngine`` on
    ``accel_device``: the card unless the caller asks for the CPU, as the
    JAX package puts it on its accelerator). Each compute engine draws its
    own params from ``cfg.seed + engine_id`` unless ``params`` is given.
    cpu-mp process engines are spawned apart (``process_engine.py``); this
    builds their in-parent offload engine with ``inference_engines=0``.
    Returns (engines, total_engine_count)."""
    from deeprecsys_tpu_torch.serving.buckets import resolve_buckets

    # One ladder for the pool (autotuning samples the size distribution).
    buckets = resolve_buckets(cfg)
    device = "cpu" if cfg.engine_backend == "cpu" else "cuda"
    engines = []
    for i in range(cfg.inference_engines):
        eid = id_base + i
        if cfg.engine_backend == "sim":
            if latency_model is None:
                raise ValueError("sim backend requires a latency_model")
            engines.append(SimEngine(eid, model_cfg, cfg, request_q, response_q,
                                     ready_q, latency_model))
        else:
            engines.append(
                ComputeEngine(eid, model_cfg, cfg, request_q, response_q, ready_q,
                              device=device, params=params, seed=cfg.seed + eid,
                              mesh=mesh, buckets=buckets, strict_buckets=False))
    total = cfg.inference_engines
    if cfg.model_accel:
        aid = id_base + total
        if accel_latency_model is not None:
            engines.append(SimEngine(aid, model_cfg, cfg, accel_request_q,
                                     response_q, ready_q, accel_latency_model))
        elif cfg.engine_backend == "sim":
            # A hardware-free run stays hardware-free.
            raise ValueError(
                "sim backend with model_accel requires an "
                "accel_latency_model (the offload engine would otherwise "
                "run on real hardware)")
        else:
            engines.append(
                ComputeEngine(aid, model_cfg, cfg, accel_request_q, response_q,
                              ready_q, device=accel_device, params=params,
                              seed=cfg.seed + aid, mesh=mesh, buckets=buckets,
                              strict_buckets=False))
        total += 1
    return engines, total
