"""HTTP serving ingress.

Counterpart of ``deeprecsys_tpu/serving/ingress.py``. The reference has
no external request API (its queries come from its own load generator);
this front end takes the load generator's place (partition, route) and
everything behind it is ``run_serving``'s machinery: engines, buckets,
coalescing, the offload engine.

    HTTP clients -> ThreadingHTTPServer (a handler thread a request)
      -> ServingServer.submit / predict: split into sub-requests, enqueue,
         wait on the query's event
      -> engine request queue -> engines (threads on the card or the CPU,
         or cpu-mp engine processes over shared-memory rings)
      -> response queue -> router thread: joins the sub-responses by
         (epoch, batch_id) and wakes the handler

Endpoints: ``POST /v1/infer`` ``{"batch_size": N}`` (a load-modeling
query), ``POST /v1/predict`` (client features: padded ``indices`` or the
ragged ``lengths`` + flat ``values``; returns their scores), ``POST
/v1/reload`` ``{"path": ...}`` (a zero-downtime checkpoint swap) and ``GET
/v1/reload`` (its status), ``GET /v1/healthz``, ``/v1/stats``, ``/metrics``
(Prometheus text), ``/v1/models`` and the per-model ``/v1/models/<name>/...``
routes.

Differences from the JAX package's: ``predict`` takes the backends
"gpu", "cpu" and "cpu-mp" (the JAX package: "tpu", "cpu", "cpu-mp"); the
offload engine of a cpu-mp server runs on ``accel_device``, the card unless
the caller asks for the CPU; and an engine answers a payload with an id
outside its table ``ERR_PAYLOAD``, which the handler maps to HTTP 400 like
the ingress's own id check (the JAX engine would read a neighbour table's
row).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deeprecsys_tpu_torch.config import ModelConfig, ServingConfig
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel
from deeprecsys_tpu_torch.serving.load_generator import partition_query
from deeprecsys_tpu_torch.serving.packets import (
    ERR_DEADLINE, ERR_PAYLOAD, ERR_READBACK, RELOAD_ACK_BATCH_ID, ServiceRequest)


class InferenceError(RuntimeError):
    """An engine answered with an error (``code``: a ``packets.ERR_*``).
    HTTP: ERR_DEADLINE 504, ERR_PAYLOAD 400, any other 500."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class OverloadedError(RuntimeError):
    """No transport capacity for the query (every blob-arena slot in
    flight); the client may retry. HTTP 503."""


class _Pending:
    """One submitted query awaiting its sub-batches' responses."""

    __slots__ = ("remaining", "responses", "event")

    def __init__(self, n_sub: int):
        self.remaining = n_sub
        self.responses = []
        self.event = threading.Event()


class ServingServer:
    """An engine pool and a response router behind a synchronous
    ``submit``/``predict`` API. Backends as ``run_serving``'s: "gpu" or
    "cpu" compute engines, "cpu-mp" engine processes, "sim" engines; with
    ``model_accel`` an offload engine for big queries (on ``accel_device``
    unless it is a sim engine)."""

    def __init__(self, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                 latency_model: LatencyModel | None = None,
                 accel_latency_model: LatencyModel | None = None, params=None,
                 checkpoint_path: str | None = None, mesh=None, accel_device: str = "cuda"):
        from deeprecsys_tpu_torch.serving.engine import build_engine_pool

        self.model_cfg = model_cfg
        self.cfg = cfg = serving_cfg
        self._batch_ids = itertools.count()
        self._pending: dict[tuple, _Pending] = {}
        self._lock = threading.Lock()
        # Percentiles over the most recent completions: bounded memory.
        self._completed_ms = collections.deque(maxlen=100_000)
        self._n_completed = 0
        self._t_start: float | None = None
        self._stop = threading.Event()
        self._stopped = False
        self.procs: list = []
        self._cleanup = None
        self._arena = None
        self._slot_owners: dict[tuple, int] = {}  # (epoch, batch_id, sub_id) -> slot
        self._reload_handles: list = []
        self._mp_reload: dict[tuple, object] = {}  # cpu-mp: (engine, gen) -> handle
        self.arena_faults = 0  # the router's arena-guard trips, in /v1/healthz
        self.accel_request_q: queue.Queue = queue.Queue(maxsize=32)
        self._accel_router = None
        self._accel_ready_q = None
        self.engines = []
        if cfg.engine_backend != "cpu-mp":
            if params is None and checkpoint_path:
                from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

                params = checkpoint_params(model_cfg, checkpoint_path,
                                           "cpu" if cfg.engine_backend == "cpu" else "cuda")
            self.request_q = queue.Queue(maxsize=1024)
            self.response_q = queue.Queue()
            self.ready_q = queue.Queue()
            self.engines, self.n_engines = build_engine_pool(
                model_cfg, cfg, self.request_q, self.accel_request_q, self.response_q,
                self.ready_q, latency_model, accel_latency_model, params, mesh=mesh,
                accel_device=accel_device)
            self._router = threading.Thread(target=self._route_loop, daemon=True,
                                            name="ingress-router")
            return
        # cpu-mp: engine processes over the rings (the reference topology),
        # and with model_accel an offload engine in this process, fed by the
        # in-process accel queue and answered on its own queue and router.
        if mesh is not None:
            raise NotImplementedError("mesh with cpu-mp ingress")
        if params is not None:
            raise ValueError("cpu-mp engines cannot take a params pytree; pass "
                             "checkpoint_path= instead (each child loads it)")
        from deeprecsys_tpu_torch.serving.process_engine import spawn_process_engines

        (self.request_q, self.response_q, self.ready_q, self.procs, self._cleanup,
         self._control_rings, self._arena) = spawn_process_engines(
             model_cfg, cfg, checkpoint_path=checkpoint_path)
        self.n_engines = cfg.inference_engines
        self._mp_reload_gen = 0
        self._mp_send_lock = threading.Lock()
        self._router = threading.Thread(target=self._route_loop, daemon=True,
                                        name="ingress-router")
        if not cfg.model_accel:
            return
        self._accel_resp_q: queue.Queue = queue.Queue()
        self._accel_ready_q = queue.Queue()
        try:
            accel_params = None
            if checkpoint_path and accel_latency_model is None:  # the processes' weights
                from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

                accel_params = checkpoint_params(model_cfg, checkpoint_path, accel_device)
            (accel,), _ = build_engine_pool(
                model_cfg, dataclasses.replace(cfg, inference_engines=0), None,
                self.accel_request_q, self._accel_resp_q, self._accel_ready_q,
                accel_latency_model=accel_latency_model, params=accel_params,
                id_base=cfg.inference_engines, accel_device=accel_device)
        except BaseException:
            self.stop()
            raise
        self.engines = [accel]
        self.n_engines += 1
        self._accel_router = threading.Thread(target=self._accel_route_loop, daemon=True,
                                              name="ingress-accel-router")

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: float = 300.0):
        for e in self.engines:
            e.start()
        # cpu-mp: the ready ring carries the processes' readiness; the
        # in-parent offload engine reports on its own queue.
        for _ in range(len(self.procs) if self.procs else self.n_engines):
            got = self.ready_q.get(timeout=timeout)
            if isinstance(got, Exception):
                raise RuntimeError("engine failed during warm-up") from got
        if self._accel_ready_q is not None:
            got = self._accel_ready_q.get(timeout=timeout)
            if isinstance(got, Exception):
                raise RuntimeError("accel engine failed during warm-up") from got
            self._accel_router.start()
        self._router.start()
        self._t_start = time.time()

    def stop(self):
        """Stop the engines, the routers and (cpu-mp) the processes, and
        unlink the shared memory. Idempotent: a second stop must not push
        into an unmapped ring."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        for e in self.engines:
            (self.accel_request_q if e.request_q is self.accel_request_q
             else self.request_q).put(None)
        for _ in self.procs:
            self.request_q.put(None)
        for e in self.engines:
            if e.is_alive():
                e.join(timeout=30)
        self._stop.set()  # the routers poll the rings: stop them first
        for router in (self._router, self._accel_router):
            if router is not None and router.is_alive():
                router.join(timeout=5)
        if self._cleanup is not None:
            self._cleanup()

    # -- request path --------------------------------------------------------

    def submit(self, batch_size: int, exp: bool = False, timeout: float = 60.0,
               deadline_ms: float | None = None) -> dict:
        """A load-modeling query of ``batch_size`` rows; blocks until its
        sub-batches are answered and returns the reference's latency split
        (min arrival, max inference end over the sub-batches,
        ``DeepRecSys.py:101-123``). ``deadline_ms`` (from arrival) reaches
        every sub-request: an engine answers an expired one without running
        it, and this raises InferenceError(ERR_DEADLINE)."""
        batch_size = max(1, min(int(batch_size), self.cfg.max_mini_batch_size))
        return self._run_query(batch_size, exp, timeout, deadline_ms, None)

    def predict(self, indices=None, dense=None, timeout: float = 60.0,
                deadline_ms: float | None = None, lengths=None, values=None) -> dict:
        """Client features through the same fabric (split, coalesced, bucket
        padded) and back with ``scores`` (B x out_dim lists, f32).

        ``indices``: (B, T, L) per-table ids; ``dense``: (B, dense_dim)
        (required iff the model takes dense features). Ragged form:
        ``lengths`` (B, T) with flat ``values`` (CSR) or padded ``indices``
        (slots past each length ignored). Thread engines take the arrays in
        the request; engine processes through the blob arena."""
        if self.cfg.engine_backend not in ("gpu", "cpu", "cpu-mp"):
            raise NotImplementedError(f"predict needs compute engines; backend "
                                      f"{self.cfg.engine_backend!r} cannot return scores")
        m = self.model_cfg
        mask = None
        if lengths is not None:
            if not self.cfg.accept_ragged:
                raise NotImplementedError(
                    "ragged requests need accept_ragged=True on the serving config "
                    "(engines then pre-warm the masked programs)")
            from deeprecsys_tpu_torch.data.ragged import lengths_to_mask, pad_csr

            if values is not None:
                if indices is not None:
                    raise ValueError("pass either 'values' (flat CSR) or 'indices' "
                                     "(padded), not both")
                indices, mask = pad_csr(lengths, values, m.num_indices_per_lookup)
            else:
                if indices is None:
                    raise ValueError("'lengths' needs 'values' (flat CSR) or padded 'indices'")
                mask = lengths_to_mask(np.asarray(lengths), m.num_indices_per_lookup)
                # Slots past a group's length may hold anything: id 0 is valid.
                indices = np.where(mask, np.asarray(indices), 0)
        elif values is not None:
            raise ValueError("'values' requires 'lengths'")
        if indices is None:
            raise ValueError("'indices' ((B, T, L) ids) is required")
        idx = np.asarray(indices)
        if idx.dtype.kind == "f":
            # 1.0 is an id; 1.9 is refused, never truncated to row 1.
            if not np.isfinite(idx).all() or (idx != np.floor(idx)).any():
                raise ValueError("indices must be integer ids (got non-integral floats)")
        elif idx.dtype.kind not in "iu":
            raise ValueError(f"indices must be integer ids; got dtype {idx.dtype}")
        T, L = m.num_tables, m.num_indices_per_lookup
        if idx.ndim != 3 or idx.shape[1:] != (T, L) or idx.shape[0] < 1:
            raise ValueError(f"indices must have shape (B, {T}, {L}) with B >= 1 for model "
                             f"{m.model_name!r}; got {idx.shape}")
        if mask is not None and mask.shape != idx.shape:
            raise ValueError(f"lengths must have shape (B, {T}) matching the batch; got mask "
                             f"shape {mask.shape} vs indices {idx.shape}")
        if idx.shape[0] > self.cfg.max_mini_batch_size:
            raise ValueError(f"batch {idx.shape[0]} exceeds max_mini_batch_size "
                             f"{self.cfg.max_mini_batch_size}")
        rows = np.asarray(m.scaled_rows, dtype=np.int64)[None, :, None]
        # Range check before the int32 cast, so that no id wraps into range.
        if (idx < 0).any() or (idx >= rows).any():
            raise ValueError("indices out of range: each id must satisfy 0 <= id < "
                             "rows(table) (per-table-local ids)")
        idx = idx.astype(np.int32)
        if m.dense_dim > 0:
            if dense is None:
                raise ValueError(f"model {m.model_name!r} takes a (B, {m.dense_dim}) dense "
                                 f"input; 'dense' is required")
            dense = np.asarray(dense, dtype=np.float32)
            if dense.shape != (idx.shape[0], m.dense_dim):
                raise ValueError(f"dense must have shape ({idx.shape[0]}, {m.dense_dim}); "
                                 f"got {dense.shape}")
        elif dense is not None:
            raise ValueError(f"model {m.model_name!r} takes no dense input")
        result, rs = self._run_query(idx.shape[0], False, timeout, deadline_ms,
                                     Batch(dense=dense, indices=idx, mask=mask),
                                     want_responses=True)
        rs = sorted(rs, key=lambda r: r.sub_id)
        result["scores"] = np.concatenate([r.scores for r in rs], axis=0).tolist()
        return result

    def _run_query(self, batch_size: int, exp: bool, timeout: float,
                   deadline_ms: float | None, payload: Batch | None,
                   want_responses: bool = False):
        cfg = self.cfg
        batch_id = next(self._batch_ids)
        arrival = time.time()
        deadline = arrival + deadline_ms / 1000.0 if deadline_ms else 0.0
        # Payload queries stay on the main pool: the offload engine may be a
        # sim engine, which computes no scores.
        to_accel = (payload is None and cfg.model_accel
                    and batch_size >= cfg.accel_request_size_thres)
        chunks = [batch_size] if to_accel else partition_query(batch_size,
                                                               cfg.sub_task_batch_size)
        key = (0, batch_id, exp)
        pend = _Pending(len(chunks))
        with self._lock:
            self._pending[key] = pend
        target_q = self.accel_request_q if to_accel else self.request_q
        off = 0
        for sub_id, chunk in enumerate(chunks):
            sub, slot = None, -1
            if payload is not None:
                sub = Batch(dense=None if payload.dense is None else payload.dense[off:off + chunk],
                            indices=payload.indices[off:off + chunk],
                            mask=None if payload.mask is None else payload.mask[off:off + chunk])
                off += chunk
                if self._arena is not None:
                    # cpu-mp: the features cross in an arena slot. Exhaustion
                    # fails this query; sub-requests already sent resolve as
                    # stragglers, and the router frees their slots.
                    try:
                        slot = self._arena.alloc()
                    except RuntimeError as e:
                        with self._lock:
                            self._pending.pop(key, None)
                        raise OverloadedError(str(e)) from e
                    try:
                        self._arena.write_batch(slot, sub.indices, sub.dense, mask=sub.mask)
                    except Exception:
                        self._arena.free(slot)
                        with self._lock:
                            self._pending.pop(key, None)
                        raise
                    with self._lock:
                        self._slot_owners[(0, batch_id, sub_id)] = slot
                    sub = None
            target_q.put(ServiceRequest(
                batch_id=batch_id, epoch=0, arrival_time=arrival, batch_size=chunk,
                sub_id=sub_id, total_sub_batches=len(chunks), exp_packet=exp,
                deadline=deadline, payload=sub, payload_slot=slot))
        if not pend.event.wait(timeout):
            with self._lock:
                # The router may have answered between the wait and here.
                if not pend.event.is_set():
                    self._pending.pop(key, None)
                    raise TimeoutError(f"query {batch_id} timed out after {timeout}s")
        rs = pend.responses
        errs = [r for r in rs if r.error_code]
        if errs:
            # A failed sub-batch fails the query; an expired deadline is
            # reported first (the client's budget, not a server fault).
            first = next((r for r in errs if r.error_code == ERR_DEADLINE), errs[0])
            raise InferenceError(first.error_code,
                                 f"query {batch_id}: {len(errs)}/{len(rs)} sub-batch(es) "
                                 f"failed: {first.error_message()}")
        end = max(r.inference_end_time for r in rs)
        queue_start = min(r.queue_start_time for r in rs)
        latency_ms = (end - arrival) * 1000.0
        if not exp:
            with self._lock:
                self._completed_ms.append(latency_ms)
                self._n_completed += 1
        result = {
            "batch_id": batch_id,
            "batch_size": batch_size,
            "sub_batches": len(chunks),
            "accel": bool(to_accel),
            "latency_ms": latency_ms,
            "queue_wait_ms": max(queue_start - arrival, 0.0) * 1000.0,
            "inference_ms": max(end - queue_start, 0.0) * 1000.0,
            "engines": sorted({r.consumer_id for r in rs}),
        }
        return (result, rs) if want_responses else result

    def _route_loop(self):
        while not self._stop.is_set():
            try:
                r = self.response_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if r is None:  # an engine exited
                continue
            if r.batch_id == RELOAD_ACK_BATCH_ID:
                # A process's reload ACK; sub_id echoes its request's gen.
                with self._lock:
                    h = self._mp_reload.pop((r.consumer_id, r.sub_id), None)
                if h is not None:
                    if r.error_code:
                        h.error = RuntimeError(f"engine process {r.consumer_id} reload failed "
                                               f"(its output has the exception)")
                    h.event.set()
                continue
            self._ingest_response(r)

    def _accel_route_loop(self):
        """cpu-mp: the in-parent offload engine answers on its own queue."""
        while not self._stop.is_set():
            try:
                r = self._accel_resp_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if r is not None:
                self._ingest_response(r)

    def _ingest_response(self, r):
        if self._arena is not None:
            # A payload's scores came back in its slot (written before the
            # response was pushed): read them and free the slot, whether
            # this is a success, an error or a timed-out query's straggler.
            with self._lock:
                slot = self._slot_owners.pop((r.epoch, r.batch_id, r.sub_id), None)
            if slot is not None:
                if not r.error_code:
                    try:
                        r.scores = self._arena.read_scores(slot)
                    except Exception as e:
                        print(f"[deeprecsys_tpu_torch] WARNING: arena slot {slot} readback "
                              f"failed ({e!r})", flush=True)
                        r.error_code = ERR_READBACK
                try:
                    self._arena.free(slot)
                except Exception:
                    # The arena's guards raise on purpose, but the router must
                    # live on: count the fault (in /v1/healthz) and print it.
                    self.arena_faults += 1
                    print(f"[deeprecsys_tpu_torch] ERROR: arena free({slot}) raised in the "
                          f"router thread (arena_faults={self.arena_faults}):\n"
                          f"{traceback.format_exc()}", flush=True)
        key = (r.epoch, r.batch_id, r.exp_packet)
        with self._lock:
            pend = self._pending.get(key)
            if pend is None:
                return  # a timed-out query's straggler
            pend.responses.append(r)
            pend.remaining -= 1
            if pend.remaining == 0:
                del self._pending[key]
                pend.event.set()

    # -- model management ------------------------------------------------------

    def reload(self, path: str) -> list:
        """A zero-downtime swap to the checkpoint at ``path`` on every
        compute engine, each applied before the next request that engine
        serves (``ComputeEngine.request_reload``). Returns the handles (wait
        on their events, or poll ``reload_status``). Sim engines have no
        params. Engine processes take the path on their control rings."""
        if self.cfg.engine_backend == "cpu-mp":
            return self._reload_mp(path)
        targets = [e for e in self.engines if hasattr(e, "request_reload")]
        if not targets:
            raise NotImplementedError(f"reload needs in-process compute engines (backend "
                                      f"{self.cfg.engine_backend!r} has none)")
        handles = [e.request_reload(path) for e in targets]
        with self._lock:
            self._reload_handles = handles
        return handles

    def _reload_mp(self, path: str) -> list:
        """cpu-mp: ``path`` as fragments on every process's control ring.
        Sent fragments cannot be taken back, so every request is applied, in
        order: each gets its own gen tag and each ACK resolves the handle it
        answers. The whole send side holds ``_mp_send_lock``: a path too long
        raises before any handle exists, and a later gen is later on every
        ring. The in-parent offload engine reloads through its own handle."""
        from deeprecsys_tpu_torch.runtime.shm_queue import reload_fragments
        from deeprecsys_tpu_torch.serving.engine import ReloadHandle

        with self._mp_send_lock:
            with self._lock:
                gen = self._mp_reload_gen = self._mp_reload_gen % 255 + 1
            frags = reload_fragments(path, gen=gen)  # may raise: no handle yet
            handles = []
            with self._lock:
                for eid, ring in enumerate(self._control_rings):
                    h = ReloadHandle(path)
                    h.engine_id, h.gen = eid, gen
                    self._mp_reload[(eid, gen)] = h
                    handles.append((eid, ring, h))
                self._reload_handles = [h for _, _, h in handles]
            for eid, ring, h in handles:
                why = None
                if not self.procs[eid].is_alive():
                    # Its ring would take the fragments and nothing would ACK.
                    why = f"engine process {eid} is not alive; reload not delivered"
                else:
                    try:
                        for f in frags:
                            ring.put(f, timeout=5.0)
                    except TimeoutError as e:
                        why = (f"engine process {eid} control ring full ({e}); reload not "
                               f"delivered")
                if why is not None:
                    with self._lock:
                        self._mp_reload.pop((eid, gen), None)
                    h.error = RuntimeError(why)
                    h.event.set()
        out = [h for _, _, h in handles]
        accel = [e.request_reload(path) for e in self.engines if hasattr(e, "request_reload")]
        if accel:
            out += accel
            with self._lock:
                self._reload_handles = list(self._reload_handles) + accel
        return out

    def reload_status(self) -> dict:
        """{scheduled, applied, failed, errors} of the last ``reload``."""
        with self._lock:
            handles = list(self._reload_handles)
        # cpu-mp: a handle whose process died after delivery will never be
        # ACKed. Give the router a moment for an ACK sent just before the
        # death, then resolve what is left; popping its (engine, gen) entry
        # under the lock decides whether the router or this call owns it.
        suspects = [h for h in handles
                    if h.engine_id is not None and not h.event.is_set()
                    and not self.procs[h.engine_id].is_alive()]
        if suspects:
            suspects[0].event.wait(0.75)
        for h in suspects:
            with self._lock:
                claimed = self._mp_reload.pop((h.engine_id, h.gen), None) is not None
            if claimed:
                h.error = RuntimeError(f"engine process {h.engine_id} died before ACKing "
                                       f"the reload")
                h.event.set()
        applied = [h for h in handles if h.event.is_set() and h.error is None]
        failed = [h for h in handles if h.event.is_set() and h.error is not None]
        return {"scheduled": len(handles), "applied": len(applied), "failed": len(failed),
                "errors": [f"{h.path}: {h.error!r}" for h in failed]}

    # -- metrics ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._completed_ms)
            total = self._n_completed
        wall = time.time() - self._t_start if self._t_start else float("nan")
        out = {"completed": total, "wall_s": wall,
               "qps": total / wall if wall and wall > 0 else 0.0}
        if lat:
            out.update(p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)),
                       p99_ms=float(np.percentile(lat, 99)))
        return out


def _health(server: ServingServer) -> dict:
    buckets = getattr(server.engines[0], "buckets", None) if server.engines else None
    live = (sum(1 for e in server.engines if e.is_alive())
            + sum(1 for p in server.procs if p.is_alive()))
    out = {"status": "degraded" if live < server.n_engines else "ok",
           "model": server.model_cfg.model_type,
           "engines": server.n_engines, "live_engines": live,
           "buckets": list(buckets) if buckets else None}
    counts = {}
    for e in server.engines:
        # A snapshot: the engine may add a bucket while this iterates.
        for b, c in dict(getattr(e, "bucket_counts", {})).items():
            counts[b] = counts.get(b, 0) + c
    if counts:
        out["bucket_executions"] = {str(k): v for k, v in sorted(counts.items())}
    for counter in ("clamped_requests", "expired_requests", "rejected_requests"):
        n = sum(getattr(e, counter, 0) for e in server.engines)
        if n:
            out[counter] = n
    if server._arena is not None:
        # Slots staged for in-flight predict sub-requests: stuck at the
        # total is exhaustion, creeping without traffic a leak.
        out["payload_slots_in_flight"] = server._arena.in_flight()
        out["payload_slots_total"] = server._arena.n_slots
        if server.arena_faults:
            out["status"] = "degraded"
            out["arena_faults"] = server.arena_faults
    # The lookup each compute engine chose ("auto" decides an engine at a
    # time from its sampled stream).
    impls = []
    for e in server.engines:
        if not hasattr(e, "_hotcold"):
            continue
        active = e._hotcold is not None and e._hotcold_active
        entry = {"engine": e.engine_id,
                 "impl": ("hotcold" if active else "direct (hotcold disabled)"
                          if e._hotcold is not None else "direct"),
                 "hot_coverage": None if e.hot_coverage is None else round(e.hot_coverage, 4)}
        if e._hotcold is not None and e.serving_cfg.hotcold_refresh_interval > 0:
            entry["live_hot_coverage"] = (None if e.live_hot_coverage is None
                                          else round(e.live_hot_coverage, 4))
            entry["hot_refreshes"] = e.hot_refreshes
        impls.append(entry)
    if impls:
        out["embedding_impl"] = impls
    return out


def _prometheus(registry: dict[str, ServingServer]) -> str:
    """Prometheus text exposition (0.0.4) of every model's serving state:
    the scrapeable twin of /v1/healthz and /v1/stats, the JAX package's
    metric names."""
    lines = []

    def metric(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"{name}{{{lab}}} {value}")

    per_model = {name: (_health(s), s.stats()) for name, s in registry.items()}

    def across(fn):
        return [({"model": n}, fn(h, st)) for n, (h, st) in per_model.items()]

    metric("drs_up", "gauge", "1 when every engine is live, else 0",
           across(lambda h, st: 1 if h["status"] == "ok" else 0))
    metric("drs_engines_live", "gauge", "live engine threads/processes",
           across(lambda h, st: h["live_engines"]))
    metric("drs_engines_total", "gauge", "configured engines",
           across(lambda h, st: h["engines"]))
    metric("drs_queries_completed_total", "counter", "completed (non-warm-up) queries",
           across(lambda h, st: st["completed"]))
    metric("drs_qps", "gauge", "completed queries per second since start",
           across(lambda h, st: st["qps"]))
    for q in ("p50", "p95", "p99"):
        metric(f"drs_query_latency_{q}_ms", "gauge",
               f"{q} query latency over the recent completion window (ms)",
               across(lambda h, st, q=q: st.get(f"{q}_ms", float("nan"))))
    for counter, help_text in (
            ("clamped_requests", "requests undercomputed at a static ladder cap"),
            ("expired_requests", "deadline-expired requests dropped pre-dispatch"),
            ("rejected_requests", "over-ladder requests answered with an error")):
        metric(f"drs_{counter}_total", "counter", help_text,
               across(lambda h, st, c=counter: h.get(c, 0)))
    metric("drs_coalesced_requests_total", "counter",
           "requests served inside a multi-request coalesced execution",
           [({"model": n}, sum(getattr(e, "coalesced_requests", 0) for e in s.engines))
            for n, s in registry.items()])
    # Hot-set refresh telemetry, only for engines that track (an absent
    # series is Prometheus's "not applicable").
    refresh_samples, live_cov_samples = [], []
    for n, s in registry.items():
        for e in s.engines:
            if (getattr(e, "_hotcold", None) is not None
                    and e.serving_cfg.hotcold_refresh_interval > 0):
                labels = {"model": n, "engine": e.engine_id}
                refresh_samples.append((labels, e.hot_refreshes))
                if e.live_hot_coverage is not None:
                    live_cov_samples.append((labels, round(e.live_hot_coverage, 4)))
    if refresh_samples:
        metric("drs_hot_set_refreshes_total", "counter",
               "adaptive hot-set re-derivations under popularity drift", refresh_samples)
    if live_cov_samples:
        metric("drs_live_hot_coverage", "gauge",
               "windowed live hot-set hit rate (hotcold engines)", live_cov_samples)
    bucket_samples = [({"model": n, "bucket": b}, c) for n, (h, _) in per_model.items()
                      for b, c in (h.get("bucket_executions") or {}).items()]
    if bucket_samples:
        metric("drs_bucket_executions_total", "counter",
               "device executions per compiled batch bucket", bucket_samples)
    arena_samples = [({"model": n}, h["payload_slots_in_flight"])
                     for n, (h, _) in per_model.items() if "payload_slots_in_flight" in h]
    if arena_samples:
        metric("drs_payload_slots_in_flight", "gauge",
               "cpu-mp blob-arena slots staged for in-flight predict sub-requests (stuck "
               "at total = exhaustion; creeping without traffic = leak)", arena_samples)
    return "\n".join(lines) + "\n"


# The failures of a query that the handler answers (any other drops the
# connection, as in the JAX package).
_QUERY_ERRORS = (InferenceError, OverloadedError, ValueError, TypeError,
                 NotImplementedError, TimeoutError)


def _make_handler(registry: dict[str, ServingServer], default: str, reload_guard=None):
    """The request handler. The single-model routes act on ``default``;
    ``/v1/models`` lists the registry and ``/v1/models/<name>/...`` picks
    one. ``reload_guard(path)`` returns None or a reason for a 403."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json_body(self):
            """The body as a JSON object, or None after a 400."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                return payload
            except (ValueError, TypeError, AttributeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return None

        @staticmethod
        def _parse_deadline(payload):
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0")
            return deadline_ms

        def _model_route(self, suffix: str):
            """The server of ``/v1/models/<name>/<suffix>``, or None after a
            404."""
            name = self.path[len("/v1/models/"):-len("/" + suffix)]
            server = registry.get(name)
            if server is None:
                self._json(404, {"error": f"unknown model {name!r}; have {sorted(registry)}"})
            return server

        def _route(self, suffix: str):
            """The server a POST to ``/v1/<suffix>`` or
            ``/v1/models/<name>/<suffix>`` names; None for another path or
            after a 404; False for another route."""
            if self.path == f"/v1/{suffix}":
                return registry[default]
            if self.path.startswith("/v1/models/") and self.path.endswith(f"/{suffix}"):
                return self._model_route(suffix)
            return False

        def _inference_error(self, e: Exception):
            """The HTTP answer to one of ``_QUERY_ERRORS``."""
            if isinstance(e, InferenceError):
                self._json({ERR_DEADLINE: 504, ERR_PAYLOAD: 400}.get(e.code, 500),
                           {"error": str(e)})
            elif isinstance(e, (ValueError, TypeError)):
                self._json(400, {"error": f"bad request: {e}"})
            elif isinstance(e, OverloadedError):
                self._json(503, {"error": str(e)})  # retryable backpressure
            else:
                self._json(501 if isinstance(e, NotImplementedError) else 504,
                           {"error": str(e)})

        def do_GET(self):
            if self.path == "/metrics":
                body = _prometheus(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/healthz":
                self._json(200, _health(registry[default]))
            elif self.path == "/v1/stats":
                self._json(200, registry[default].stats())
            elif self.path == "/v1/models":
                self._json(200, {name: _health(s) for name, s in registry.items()})
            elif self.path == "/v1/reload":
                self._json(200, registry[default].reload_status())
            elif self.path.startswith("/v1/models/") and self.path.endswith("/reload"):
                server = self._model_route("reload")
                if server is not None:
                    self._json(200, server.reload_status())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            server = self._route("reload")
            if server is not False:
                if server is None:
                    return
                payload = self._read_json_body()
                if payload is None:
                    return
                path = payload.get("path")
                if not isinstance(path, str) or not path:
                    self._json(400, {"error": "bad request: path must be a non-empty string"})
                    return
                denied = reload_guard(path) if reload_guard is not None else None
                if denied:
                    self._json(403, {"error": denied})
                    return
                try:
                    self._json(200, {"scheduled": len(server.reload(path))})
                except NotImplementedError as e:
                    self._json(501, {"error": str(e)})
                return
            server = self._route("predict")
            if server is not False:
                if server is None:
                    return
                payload = self._read_json_body()
                if payload is None:
                    return
                try:
                    if "indices" not in payload and "values" not in payload:
                        raise ValueError("'indices' ((B, T, L) ids) or the ragged form "
                                         "('lengths' (B, T) + flat 'values') is required")
                    self._json(200, server.predict(
                        payload.get("indices"), dense=payload.get("dense"),
                        deadline_ms=self._parse_deadline(payload),
                        lengths=payload.get("lengths"), values=payload.get("values")))
                except _QUERY_ERRORS as e:
                    self._inference_error(e)
                return
            server = self._route("infer")
            if server is False:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            if server is None:
                return
            payload = self._read_json_body()
            if payload is None:
                return
            try:
                batch_size = int(payload["batch_size"])
                if batch_size < 1:
                    raise ValueError("batch_size must be >= 1")
                limit = server.cfg.max_mini_batch_size
                if batch_size > limit:
                    # Refused, not clamped: the client would time a fraction
                    # of the work it asked for.
                    raise ValueError(f"batch_size {batch_size} exceeds this server's "
                                     f"max_mini_batch_size {limit}")
                deadline_ms = self._parse_deadline(payload)
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                self._json(200, server.submit(batch_size, exp=bool(payload.get("exp", False)),
                                              deadline_ms=deadline_ms))
            except _QUERY_ERRORS as e:
                self._inference_error(e)

        def log_message(self, *a):  # quiet: /v1/stats has the numbers
            pass

    return Handler


class HttpIngress:
    """A ThreadingHTTPServer (a handler thread a query, so a slow query does
    not block a small one at the HTTP layer) over one ``ServingServer`` or a
    {name: ServingServer} registry.

    ``POST /v1/reload`` loads a caller-named path: on a loopback bind it is
    open; on any other bind only with ``reload_root``, under which every
    path must resolve (after symlinks and ``..``)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 default: str | None = None, reload_root: str | None = None):
        registry = ({server.model_cfg.model_name: server} if isinstance(server, ServingServer)
                    else dict(server))
        if not registry:
            raise ValueError("empty model registry")
        self.registry = registry
        self.default = default if default is not None else next(iter(registry))
        if self.default not in registry:
            raise ValueError(f"default {self.default!r} not in registry")
        loopback = host in ("127.0.0.1", "::1", "localhost")
        root = os.path.realpath(reload_root) if reload_root else None

        def reload_guard(path: str) -> str | None:
            if root is not None:
                real = os.path.realpath(path)
                if not (real == root or real.startswith(root + os.sep)):
                    return "checkpoint path must live under the configured reload_root"
                return None
            if not loopback:
                return ("reload is disabled on non-loopback binds; configure reload_root to "
                        "enable it")
            return None

        class _Server(ThreadingHTTPServer):
            # The stdlib backlog of 5 refuses concurrent clients: admission
            # belongs to the engine queues.
            request_queue_size = 128

        self.httpd = _Server((host, port), _make_handler(registry, self.default, reload_guard))
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="ingress-http")

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self):
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for s in self.registry.values():
            s.stop()
