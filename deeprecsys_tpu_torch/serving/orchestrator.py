"""End-to-end serving orchestration.

Counterpart of ``deeprecsys_tpu/serving/orchestrator.py`` (reference
``DeepRecSys.py:21-185``): the queues (requests, bounded 1024; accelerator
requests, bounded 32; latency feedback; responses; readiness), the engine
threads and the load generator, the response aggregation loop with its
windowed-p95 feedback to the scheduler, a watchdog for dead engines, and
the final QPS / p50 / p95 / p99 report.

``ServingResult`` has the JAX package's fields plus five of the port's:
the engines' executions per bucket and warm-up executions (so a run can
hold a kernel's launch count to the executions it served), the mean and
p99 of the load generator's pacing error, and the engines' failures. An
engine that fails mid-run (a kernel that does not launch, a readback that
fails) drops the requests it still holds, as in the JAX package, but the
result names it in ``engine_errors``: a run with failures is not a
measurement, and ``main.py --queue`` raises on one.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time

import numpy as np

from deeprecsys_tpu_torch.config import ModelConfig, ServingConfig
from deeprecsys_tpu_torch.serving.engine import build_engine_pool
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel
from deeprecsys_tpu_torch.serving.load_generator import LoadGenerator
from deeprecsys_tpu_torch.serving.metrics import ResponseAggregator


@dataclasses.dataclass
class ServingResult:
    measured_qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    num_responses: int
    cpu_requests: int
    cpu_sub_requests: int
    accel_requests: int
    optimal_sub_batch: int | None
    optimal_accel_thres: int | None
    wall_s: float
    # Latency split over non-experimental responses (ms): waiting in the
    # request queue vs executing (dispatch until the scores are readable).
    queue_wait_p95_ms: float = float("nan")
    inference_p95_ms: float = float("nan")
    # Responses that carried an engine error code instead of scores.
    error_responses: int = 0
    # The port's: executions per bucket over all compute engines, their
    # warm-up executions, and the pacing error (actual - drawn delay).
    bucket_counts: dict = dataclasses.field(default_factory=dict)
    warmup_executions: int = 0
    pacing_error_mean_ms: float = float("nan")
    pacing_error_p99_ms: float = float("nan")
    # "<engine>: <error>" for each engine that failed or died mid-run.
    engine_errors: list = dataclasses.field(default_factory=list)

    @property
    def executions(self) -> int:
        """Model executions of the compute engines, warm-up included."""
        return sum(self.bucket_counts.values()) + self.warmup_executions

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_serving(
    model_cfg: ModelConfig,
    serving_cfg: ServingConfig,
    latency_model: LatencyModel | None = None,
    accel_latency_model: LatencyModel | None = None,
    settle_s: float = 3.0,
    params=None,
    log_responses: bool = False,
    watchdog_s: float = 60.0,
    mesh=None,
    checkpoint_path: str | None = None,
) -> ServingResult:
    """Run the full serving stack and return measured QPS and tail latency.

    Engine backends (``serving_cfg.engine_backend``): "gpu", compute
    engines on the CUDA card (raises without one); "cpu", compute engines
    on the host; "sim", ``SimEngine``s driven by ``latency_model``
    (required). With ``model_accel`` one more engine takes whole big
    queries: a ``SimEngine`` over ``accel_latency_model`` if given, else a
    compute engine on the card. ``params`` (the port's tensors) are shared
    by every compute engine; None = each draws its own from its seed, or,
    with ``checkpoint_path``, all share the checkpoint's params, loaded once
    onto the engines' device (a quantized checkpoint raises: ROADMAP.md
    Queue 1 item 8).
    """
    cfg = serving_cfg
    if params is None and checkpoint_path:
        from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

        params = checkpoint_params(model_cfg, checkpoint_path,
                                   "cpu" if cfg.engine_backend == "cpu" else "cuda")
    request_q: queue.Queue = queue.Queue(maxsize=1024)
    accel_request_q: queue.Queue = queue.Queue(maxsize=32)
    pid_q: queue.Queue = queue.Queue()
    response_q: queue.Queue = queue.Queue()
    ready_q: queue.Queue = queue.Queue()
    engines, total_engines = build_engine_pool(
        model_cfg, cfg, request_q, accel_request_q, response_q, ready_q,
        latency_model, accel_latency_model, params, mesh=mesh)
    loadgen = LoadGenerator(cfg, request_q, accel_request_q, pid_q, ready_q, settle_s=settle_s)

    t0 = time.time()
    for e in engines:
        e.start()
    loadgen.start()

    agg = ResponseAggregator(cfg.req_granularity)
    finished = 0
    degraded: list[str] = []  # engines that died without their done sentinel
    # Shutdown sentinels still owed to engines after a load-generator
    # death: None = healthy so far; else (cpu_count, accel_count) left.
    shutdown_owed: "tuple[int, int] | None" = None
    # Watchdog: the reference hangs forever if an engine dies mid-run; here
    # a quiet period with no live engine (or a dead load generator) ends it.
    while finished < total_engines:
        try:
            response = response_q.get(timeout=watchdog_s)
        except queue.Empty:
            dead = [e.name for e in engines if not e.is_alive()]
            live_engines = any(e.is_alive() for e in engines)
            if (not loadgen.is_alive() and loadgen.error is not None
                    and shutdown_owed != (0, 0)):
                # The load generator died before sending the sentinels, so
                # live engines would wait forever: send them, a bounded put
                # at a time (a full queue retries on the next timeout).
                if shutdown_owed is None:
                    print("[deeprecsys_tpu_torch] WARNING: load generator died "
                          f"({loadgen.error!r}); shutting engines down", flush=True)
                    shutdown_owed = (cfg.inference_engines, 1 if cfg.model_accel else 0)
                cpu_owed, accel_owed = shutdown_owed
                try:
                    while cpu_owed > 0:
                        request_q.put(None, timeout=0.5)
                        cpu_owed -= 1
                    while accel_owed > 0:
                        accel_request_q.put(None, timeout=0.5)
                        accel_owed -= 1
                except queue.Full:
                    print(f"[deeprecsys_tpu_torch] WARNING: request queue full "
                          f"while injecting shutdown sentinels "
                          f"({cpu_owed}+{accel_owed} still owed); will retry", flush=True)
                shutdown_owed = (cpu_owed, accel_owed)
                continue
            if loadgen.is_alive() and not live_engines:
                # No consumer left: the load generator will block on the
                # bounded queue forever. Abort; the threads are daemons.
                raise RuntimeError(
                    f"serving stalled: no responses for {watchdog_s}s and "
                    f"ALL engines exited (dead: {dead}) while the load "
                    f"generator is still running (blocked on a full "
                    f"queue); {finished}/{total_engines} engines had "
                    f"signalled done")
            if not loadgen.is_alive() and not live_engines:
                if finished > 0:
                    # Every engine exited and at least one finished cleanly:
                    # the missing sentinels belong to crashed engines, and
                    # the survivors absorbed the shared queue. Complete
                    # degraded. (A slow engine is alive and keeps this off.)
                    print(f"[deeprecsys_tpu_torch] WARNING: "
                          f"{total_engines - finished} engine(s) died mid-run "
                          f"(exited: {dead}); completing degraded", flush=True)
                    degraded.append(f"{total_engines - finished} engine(s) exited "
                                    f"without their done sentinel")
                    break
                raise RuntimeError(
                    f"serving stalled: no responses for {watchdog_s}s, load "
                    f"generator and engines all exited (dead: {dead}); "
                    f"{finished}/{total_engines} engines had signalled done")
            continue  # engines still alive: slow, not dead
        if response is None:
            finished += 1
            continue
        windowed_p95 = agg.add(response)
        if windowed_p95 is not None:
            if cfg.debug_mode:
                print(f"Running latency: {windowed_p95:.3f} ms", flush=True)
            pid_q.put(windowed_p95)

    loadgen.join()
    for e in engines:
        e.join()
    if loadgen.error is not None:
        raise RuntimeError("load generator failed") from loadgen.error
    wall = time.time() - t0

    if log_responses and cfg.log_file:
        d = os.path.dirname(cfg.log_file)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(cfg.log_file, "w") as f:
            for r in agg.responses:
                f.write(str(dataclasses.asdict(r)) + "\n")

    sub_opt = loadgen.cpu_scheduler.optimal_config if cfg.tune_batch_qps else None
    accel_opt = loadgen.accel_scheduler.optimal_config if cfg.tune_accel_qps else None
    finals = [r for r in agg.responses if not r.exp_packet]
    qwait = [max(r.queue_start_time - r.arrival_time, 0.0) * 1000 for r in finals]
    infer = [max(r.inference_end_time - r.queue_start_time, 0.0) * 1000 for r in finals]
    bucket_counts: dict[int, int] = {}
    for e in engines:
        for b, n in getattr(e, "bucket_counts", {}).items():
            bucket_counts[b] = bucket_counts.get(b, 0) + n
    pacing_ms = np.asarray(loadgen.pacing_errors_s) * 1000.0
    return ServingResult(
        measured_qps=agg.measured_qps(),
        p50_ms=agg.tail_latency_ms(50),
        p95_ms=agg.tail_latency_ms(95),
        p99_ms=agg.tail_latency_ms(99),
        num_responses=len(agg.responses),
        cpu_requests=loadgen.cpu_requests,
        cpu_sub_requests=loadgen.cpu_sub_requests,
        accel_requests=loadgen.accel_requests,
        optimal_sub_batch=sub_opt,
        optimal_accel_thres=accel_opt,
        wall_s=wall,
        queue_wait_p95_ms=float(np.percentile(qwait, 95)) if qwait else float("nan"),
        inference_p95_ms=float(np.percentile(infer, 95)) if infer else float("nan"),
        error_responses=sum(agg.error_counts.values()),
        bucket_counts=dict(sorted(bucket_counts.items())),
        warmup_executions=sum(getattr(e, "warmup_executions", 0) for e in engines),
        pacing_error_mean_ms=float(pacing_ms.mean()) if pacing_ms.size else float("nan"),
        pacing_error_p99_ms=(float(np.percentile(pacing_ms, 99)) if pacing_ms.size
                             else float("nan")),
        engine_errors=[f"{e.name}: {e.error!r}" for e in engines
                       if getattr(e, "error", None) is not None] + degraded,
    )
