"""DeepRecSched: the hill-climbing QPS-under-SLA scheduler.

Counterpart of ``deeprecsys_tpu/serving/scheduler.py``, copied (reference
``scheduler.py``). Two nested optimizations:

Inner loop (:48-84): a 3-region controller over candidate Poisson
inter-arrival times (logspace between min/max range): if the running p95
exceeds the SLA target, step to a slower arrival rate; if it is below
``target / (1 + stable_region)``, step faster; else hold. After
``sched_timeout`` updates, the median of the last ``arr_steps`` attempted
rates is the config's sustainable rate.

Outer loop (:90-155): hill-climb over a config list (per-engine sub-batch
sizes in "cpu" mode, the big-query offload threshold in "accel" mode).
Stop when the new config's sustainable rate is worse (a higher
inter-arrival time) than the previous one, and back off to it, or after
trying all configs, and pick the argmin. Between configs the request
queues are drained and the system settles.

A pure state machine: the load generator applies the returned
drain-and-settle actions, and reads the tuned knob from ``TuningState``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprecsys_tpu_torch.config import ServingConfig


@dataclasses.dataclass
class TuningState:
    """Knobs shared between scheduler, load generator and engines."""

    sub_task_batch_size: int
    accel_request_size_thres: int


@dataclasses.dataclass
class SchedulerStep:
    arrival_rate_ms: float
    tuning: bool
    drain_and_settle: bool  # caller should drain request queues + settle


class DeepRecScheduler:
    def __init__(self, cfg: ServingConfig, state: TuningState, mode: str = "cpu"):
        if mode not in ("cpu", "accel"):
            raise ValueError(f"unsupported scheduling mode {mode!r}")
        self.cfg = cfg
        self.state = state
        self.mode = mode
        self.rates = np.logspace(
            np.log10(cfg.min_arr_range), np.log10(cfg.max_arr_range), num=cfg.arr_steps
        )
        self.arr_id = int(np.argmin(np.abs(self.rates - cfg.avg_arrival_rate_ms)))
        self.arrival_rate = float(cfg.avg_arrival_rate_ms)
        self.configs = list(cfg.batch_configs if mode == "cpu" else cfg.accel_configs)
        self.qps_tried = 0
        self.tried_rates: list[float] = []
        self.config_rates: list[float] = []
        self.config_attempt = 0
        self.tuning = True
        self.optimal_config: int | None = None

    def _apply_config(self, value: int):
        if self.mode == "cpu":
            self.state.sub_task_batch_size = int(value)
        else:
            self.state.accel_request_size_thres = int(value)
        self.optimal_config = int(value)

    def step(self, running_latency_ms: float) -> SchedulerStep:
        cfg = self.cfg
        # --- inner 3-region controller -------------------------------
        if running_latency_ms > cfg.target_latency_ms:
            # over SLA: increase inter-arrival time (lower QPS)
            self.arr_id = min(len(self.rates) - 1, self.arr_id + 1)
        elif running_latency_ms < cfg.target_latency_ms / (1.0 + cfg.stable_region):
            # comfortably under SLA: decrease inter-arrival time (raise QPS)
            self.arr_id = max(0, self.arr_id - 1)
        # else: inside the stable region, hold
        self.arrival_rate = float(self.rates[self.arr_id])
        self.tried_rates.append(self.arrival_rate)
        self.qps_tried += 1

        drain = False
        if self.qps_tried > cfg.sched_timeout:
            # This config has converged: its sustainable rate is the median
            # of the recent attempts.
            self.arrival_rate = float(np.median(self.tried_rates[-cfg.arr_steps:]))
            self.config_rates.append(self.arrival_rate)
            self.config_attempt += 1
            drain = True

            if len(self.config_rates) >= 2 and self.config_rates[-1] > self.config_rates[-2]:
                # Worse than the previous config (higher inter-arrival time
                # = lower sustainable QPS): hill-climb back-off.
                self.arrival_rate = self.config_rates[self.config_attempt - 2]
                self.qps_tried = 0
                if self.tuning:
                    self.tuning = False
                    self._apply_config(self.configs[self.config_attempt - 2])
            elif len(self.config_rates) == len(self.configs):
                # Tried everything; best is the argmin inter-arrival time.
                best = int(np.argmin(self.config_rates))
                self.arrival_rate = float(min(self.config_rates))
                self.qps_tried = 0
                if self.tuning:
                    self.tuning = False
                    self._apply_config(self.configs[best])
            else:
                # Keep climbing: next config, restart the inner loop.
                if self.tuning:
                    self._apply_config(self.configs[self.config_attempt])
                    self.optimal_config = None  # still tuning
                self.tried_rates = []
                self.qps_tried = 0
                self.arrival_rate = float(cfg.avg_arrival_rate_ms)
                self.arr_id = int(np.argmin(np.abs(self.rates - cfg.avg_arrival_rate_ms)))

        return SchedulerStep(self.arrival_rate, self.tuning, drain)
