"""CPU engine processes over shared-memory rings (``engine_backend="cpu-mp"``).

Counterpart of ``deeprecsys_tpu/serving/process_engine.py`` (reference
``DeepRecSys.py:62-78``: a pool of CPU inference-engine OS processes around
multiprocessing queues). Each process runs the port's ``ComputeEngine``
serving loop, synchronously in its main thread, on the CPU, over
``ShmRingQueue``s: the native rings carry the same 64-byte packets as the
JAX package's, with no pickling. A request's features and scores cross in
a ``BlobArena`` slot; a reload path crosses on the engine's own control
ring.

The processes are started with the ``spawn`` method and never touch the
card (a big query's offload engine stays in the parent, on the card):
each builds its ``ComputeEngine`` with ``device="cpu"`` and one intra-op
thread, since the processes are the parallelism. Trained weights reach a
process as a checkpoint path, which it loads itself.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

from deeprecsys_tpu_torch.config import ModelConfig, ServingConfig

# Packets a request or response ring holds (the thread engines' request
# queue is bounded at 1024 too).
RING_CAPACITY = 1024


def _engine_child(engine_id: int, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                  req_name: str, resp_name: str, ready_name: str,
                  ctl_name: str | None = None, checkpoint_path: str | None = None,
                  arena_spec: tuple[str, int, int] | None = None):
    """An engine process's body. A failure before the serving loop (ring
    attach, checkpoint load, engine set-up) is reported on the ready ring,
    with a response sentinel so the aggregator's engine count stays right,
    and the process returns: it never dies silently with the parent waiting
    on its readiness."""
    import torch

    from deeprecsys_tpu_torch.runtime.shm_queue import ShmRingQueue
    from deeprecsys_tpu_torch.serving.engine import ComputeEngine

    ready_q = response_q = None
    try:
        # The ready ring first: it reports the other attaches' failures.
        ready_q = _ReadySender(ShmRingQueue(64, shm_name=ready_name, create=False),
                               engine_id=engine_id)
        request_q = ShmRingQueue(RING_CAPACITY, shm_name=req_name, create=False)
        response_q = ShmRingQueue(RING_CAPACITY, shm_name=resp_name, create=False)
        control_q = ShmRingQueue(64, shm_name=ctl_name, create=False) if ctl_name else None
        torch.set_num_threads(1)
        params = None
        if checkpoint_path:
            from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

            params = checkpoint_params(model_cfg, checkpoint_path, "cpu")
        arena = None
        if arena_spec is not None:
            from deeprecsys_tpu_torch.runtime.blob_arena import BlobArena

            name, n_slots, slot_b = arena_spec
            arena = BlobArena(name, n_slots, slot_b, create=False)
        engine = ComputeEngine(
            engine_id, model_cfg, serving_cfg, request_q, response_q, ready_q,
            device="cpu", params=params, seed=serving_cfg.seed + engine_id,
            strict_buckets=False, control_q=control_q, arena=arena)
    except Exception as e:
        print(f"[deeprecsys_tpu_torch] engine child {engine_id} failed before serving: "
              f"{e!r}", flush=True)
        try:
            if ready_q is not None:
                ready_q.put(e)
            if response_q is not None:
                response_q.put(None)
        except Exception:
            pass
        return
    engine.run()


class _ReadySender:
    """The readiness protocol on a packet ring: ready is a request with
    ``batch_id = engine_id``, a set-up failure one with ``batch_id =
    -(engine_id + 1)`` (a packet cannot carry the exception; the process
    prints it)."""

    def __init__(self, ring, engine_id: int | None = None):
        self.ring = ring
        self.engine_id = engine_id

    def put(self, item):
        from deeprecsys_tpu_torch.serving.packets import ServiceRequest

        if isinstance(item, Exception):
            eid = self.engine_id if self.engine_id is not None else 0
            self.ring.put(ServiceRequest(batch_id=-(eid + 1)))
        else:
            self.ring.put(ServiceRequest(batch_id=int(item)))


class _ReadyReceiver:
    """The ``queue.Queue`` view of the ready ring that the load generator's
    barrier reads: an engine id, or a RuntimeError for a failed set-up."""

    def __init__(self, ring):
        self.ring = ring

    def put(self, item):  # an engine in the parent signals here too
        _ReadySender(self.ring).put(item)

    def get(self, timeout=None):
        pkt = self.ring.get(timeout=timeout)
        if pkt is not None and pkt.batch_id < 0:
            return RuntimeError(f"engine process {-pkt.batch_id - 1} failed during setup "
                                f"(its output has the exception)")
        return pkt.batch_id if pkt is not None else None


def spawn_process_engines(model_cfg: ModelConfig, cfg: ServingConfig,
                          checkpoint_path: str | None = None):
    """The rings, the blob arena and ``cfg.inference_engines`` engine
    processes. Returns (request_q, response_q, ready_receiver, processes,
    cleanup, control_rings, arena): ``control_rings[i]`` takes engine i's
    ``reload_fragments`` (it ACKs on the response ring with ``batch_id =
    RELOAD_ACK_BATCH_ID``); ``arena`` (``cfg.payload_arena_slots`` slots,
    each sized for the largest sub-request) carries payloads; ``cleanup()`` joins or terminates the processes and
    unlinks every segment. Each process starts from ``checkpoint_path``'s
    weights when given, else from its seed."""
    from deeprecsys_tpu_torch.runtime.blob_arena import BlobArena, slot_bytes_for
    from deeprecsys_tpu_torch.runtime.shm_queue import ShmRingQueue

    # The pid keeps the names of concurrent servers (test workers) apart.
    tag = f"drs{os.getpid()}_{time.time_ns() % 1_000_000_000}"
    segments, procs = [], []

    def cleanup():
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        while segments:  # a second call finds none left
            seg = segments.pop()
            seg.close()
            seg.unlink()

    try:
        def ring(suffix: str, cap: int):
            segments.append(ShmRingQueue(cap, shm_name=f"{tag}_{suffix}", create=True))
            return segments[-1]

        request_q, response_q = ring("req", RING_CAPACITY), ring("resp", RING_CAPACITY)
        ready = _ReadyReceiver(ring("rdy", 64))
        control_rings = [ring(f"ctl{i}", 64) for i in range(cfg.inference_engines)]
        slot_rows = max(1, min(cfg.sub_task_batch_size, cfg.max_mini_batch_size))
        slot_b = slot_bytes_for(slot_rows, model_cfg.num_tables, model_cfg.num_indices_per_lookup,
                                model_cfg.dense_dim, model_cfg.out_dim,
                                with_mask=cfg.accept_ragged)
        arena = BlobArena(f"{tag}_blob", cfg.payload_arena_slots, slot_b, create=True)
        segments.append(arena)
        ctx = mp.get_context("spawn")
        for i in range(cfg.inference_engines):
            p = ctx.Process(
                target=_engine_child, daemon=True, name=f"engine-proc-{i}",
                args=(i, model_cfg, cfg, request_q.name, response_q.name, ready.ring.name,
                      control_rings[i].name, checkpoint_path,
                      (arena.name, arena.n_slots, arena.slot_bytes)))
            p.start()
            procs.append(p)
    except BaseException:
        cleanup()
        raise
    return request_q, response_q, ready, procs, cleanup, control_rings, arena
