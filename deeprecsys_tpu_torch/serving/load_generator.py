"""Load generator: query synthesis, routing and pacing.

Counterpart of ``deeprecsys_tpu/serving/load_generator.py``, copied
(reference ``loadGenerator.py``): Poisson inter-arrival delays, redrawn a
query (:198-199); query sizes from a normal, lognormal, fixed or file
distribution clipped to [1, max] (:20-43); each query split into
``sub_task_batch_size`` chunks (:46-54) or routed whole to the accelerator
above a size threshold (:162-177); a readiness barrier on the engines
(:74-78); both hill-climbing schedulers (:121-158); done sentinels and
counts (:207-217). The numpy draws are the same calls in the same order,
so one seed gives the JAX package's request stream.

One deliberate difference (ROADMAP.md Queue 3): pacing. The JAX package
paces with a native sleep that releases the GIL, and falls back to a
GIL-holding busy-wait below 5.5 ms, which would stall the engine threads
that need the GIL to dispatch. The port sleeps with ``time.sleep``
throughout: on Linux it is ``clock_nanosleep`` with the GIL released. It
sleeps until each query's place on the schedule (the sum of the drawn
delays since the first query, restarted after a drain-and-settle), not
for each drawn delay, so a late wake-up does not push every later arrival
back. The generator records each query's lateness against the schedule
in ``pacing_errors_s``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving.packets import ServiceRequest
from deeprecsys_tpu_torch.serving.scheduler import DeepRecScheduler, TuningState


def model_batch_sizes(cfg: ServingConfig, rng: np.random.Generator) -> np.ndarray:
    """Per-query sizes from the configured distribution, clipped to
    [1, max_mini_batch_size]."""
    n = cfg.num_batches
    if cfg.batch_size_distribution == "normal":
        sizes = rng.normal(cfg.avg_mini_batch_size, cfg.var_mini_batch_size, n)
    elif cfg.batch_size_distribution == "lognormal":
        sizes = rng.lognormal(cfg.avg_mini_batch_size, cfg.var_mini_batch_size, n)
    elif cfg.batch_size_distribution == "fixed":
        sizes = np.full(n, cfg.avg_mini_batch_size)
    elif cfg.batch_size_distribution == "file":
        with open(cfg.batch_dist_file) as f:
            percentiles = [float(line.strip()) for line in f if line.strip()]
        # integers(), not int(uniform()): uniform(0, high) can round to high.
        sizes = np.asarray([percentiles[rng.integers(0, len(percentiles))]
                            for _ in range(n)])
    else:
        raise ValueError(f"unknown batch_size_distribution {cfg.batch_size_distribution!r}")
    return np.clip(sizes, 1, cfg.max_mini_batch_size).astype(np.int64)


def partition_query(batch_size: int, sub_task_batch_size: int) -> list[int]:
    """Split a query into sub-batches of at most ``sub_task_batch_size``."""
    if sub_task_batch_size <= 0:
        raise ValueError(
            f"sub_task_batch_size must be positive, got {sub_task_batch_size}")
    out = []
    while batch_size > 0:
        chunk = min(sub_task_batch_size, batch_size)
        out.append(chunk)
        batch_size -= chunk
    return out


def sleep_until(deadline: float) -> float:
    """Sleep until ``time.perf_counter()`` reaches ``deadline``, with the
    GIL released (``time.sleep`` is ``clock_nanosleep`` on Linux), so
    pacing never starves the engine threads. Returns the lateness: the
    wake-up time minus ``deadline`` (>= 0)."""
    delay = deadline - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    return time.perf_counter() - deadline


class LoadGenerator(threading.Thread):
    """Drives the request queues; optionally runs the DeepRecSched tuners.

    The scheduler's drain-and-settle transitions (reference
    ``scheduler.py:157-174``) are executed here: the request queues are
    emptied and the system settles for ``settle_s`` before the next config.
    """

    def __init__(
        self,
        cfg: ServingConfig,
        request_q: "queue.Queue",
        accel_request_q: "queue.Queue",
        pid_q: "queue.Queue",
        ready_q: "queue.Queue",
        settle_s: float = 3.0,
    ):
        super().__init__(name="load-generator", daemon=True)
        self.cfg = cfg
        self.request_q = request_q
        self.accel_request_q = accel_request_q
        self.pid_q = pid_q
        self.ready_q = ready_q
        self.settle_s = settle_s
        self.rng = np.random.default_rng(cfg.seed)
        self.state = TuningState(cfg.sub_task_batch_size, cfg.accel_request_size_thres)
        self.cpu_scheduler = DeepRecScheduler(cfg, self.state, mode="cpu")
        self.accel_scheduler = DeepRecScheduler(cfg, self.state, mode="accel")
        # Totals (loadGenerator.py:84-86, 216-217)
        self.cpu_sub_requests = 0
        self.cpu_requests = 0
        self.accel_requests = 0
        self.pacing_errors_s: list[float] = []  # lateness against the schedule, a query
        self.error: Exception | None = None

    def _drain_and_settle(self):
        for q in (self.request_q, self.accel_request_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        time.sleep(self.settle_s)
        while True:
            try:
                self.pid_q.get_nowait()
            except queue.Empty:
                break

    def run(self):
        try:
            self._run()
        except Exception as e:
            self.error = e
            raise

    def _run(self):
        cfg = self.cfg
        # Barrier: wait for every engine to signal readiness.
        for _ in range(cfg.inference_engines + (1 if cfg.model_accel else 0)):
            item = self.ready_q.get()
            if isinstance(item, Exception):
                raise RuntimeError(f"engine failed during setup: {item}") from item

        batch_sizes = model_batch_sizes(cfg, self.rng)

        tuning_batch = cfg.tune_batch_qps
        tuning_accel = False
        arrival_rate = cfg.avg_arrival_rate_ms
        if tuning_batch:
            self.state.sub_task_batch_size = int(cfg.batch_configs[0])
            # No accelerator while the sub-batch is tuned: sizes are clipped
            # inclusively to max and routed with >=, so the threshold sits
            # one above max.
            self.state.accel_request_size_thres = cfg.max_mini_batch_size + 1

        epoch = 0
        exp_epochs = 0
        t_next = time.perf_counter()  # the next query's place on the schedule
        while tuning_batch or tuning_accel or (exp_epochs < cfg.nepochs):
            for batch_id in range(cfg.num_batches):
                if tuning_batch and self.pid_q.qsize() > 0:
                    step = self.cpu_scheduler.step(self.pid_q.get())
                    arrival_rate, tuning_batch = step.arrival_rate_ms, step.tuning
                    if step.drain_and_settle:
                        self._drain_and_settle()
                        t_next = time.perf_counter()
                    if not tuning_batch:
                        # Batch tuning is over: restore the configured
                        # offload threshold.
                        self.state.accel_request_size_thres = \
                            cfg.accel_request_size_thres
                        if cfg.model_accel and cfg.tune_accel_qps:
                            tuning_accel = True
                        continue
                if cfg.model_accel and tuning_accel and self.pid_q.qsize() > 0:
                    step = self.accel_scheduler.step(self.pid_q.get())
                    arrival_rate, tuning_accel = step.arrival_rate_ms, step.tuning
                    if step.drain_and_settle:
                        self._drain_and_settle()
                        t_next = time.perf_counter()
                    if not tuning_accel:
                        continue

                size = int(batch_sizes[batch_id])
                exp = tuning_batch or tuning_accel
                if cfg.model_accel and size >= self.state.accel_request_size_thres:
                    self.accel_request_q.put(
                        ServiceRequest(batch_id=batch_id, epoch=epoch, batch_size=size,
                                       sub_id=0, total_sub_batches=1, exp_packet=exp,
                                       arrival_time=time.time())
                    )
                    self.accel_requests += 1
                else:
                    chunks = partition_query(size, self.state.sub_task_batch_size)
                    for i, chunk in enumerate(chunks):
                        self.request_q.put(
                            ServiceRequest(batch_id=batch_id, epoch=epoch, batch_size=chunk,
                                           sub_id=i, total_sub_batches=len(chunks),
                                           exp_packet=exp, arrival_time=time.time())
                        )
                        self.cpu_sub_requests += 1
                    self.cpu_requests += 1

                t_next += self.rng.poisson(lam=arrival_rate) / 1000.0
                self.pacing_errors_s.append(sleep_until(t_next))
            epoch += 1
            if not tuning_batch and not tuning_accel:
                exp_epochs += 1

        # Done sentinels: one per engine (loadGenerator.py:207-214).
        for _ in range(self.cfg.inference_engines):
            self.request_q.put(None)
        if cfg.model_accel:
            self.accel_request_q.put(None)
