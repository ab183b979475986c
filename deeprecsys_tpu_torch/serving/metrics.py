"""Response aggregation and tail-latency metrics.

Counterpart of ``deeprecsys_tpu/serving/metrics.py``, copied (reference
``DeepRecSys.py:89-175``): sub-batch responses are joined per query under
the key (epoch, batch_id, exp_packet), taking min(arrival) and
max(inference_end); every ``req_granularity`` completed queries the
windowed p95 goes to the scheduler; at the end, measured QPS (over
sub_id == 0 non-experimental responses) and p95/p99 are reported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprecsys_tpu_torch.serving.packets import ServiceResponse


@dataclasses.dataclass
class QueryJoin:
    arrival: float
    inference_end: float
    remaining: int


class ResponseAggregator:
    """Joins sub-batch responses into per-query latencies."""

    def __init__(self, req_granularity: int = 64):
        self.req_granularity = req_granularity
        self._open: dict[tuple, QueryJoin] = {}
        self.latencies: list[float] = []          # all completed queries (s)
        self.final_latencies: list[float] = []    # non-exp_packet only (s)
        self.responses: list[ServiceResponse] = []
        # error_code -> count over ingested responses (an answered failure
        # completes the join but carries no scores).
        self.error_counts: dict[int, int] = {}

    def add(self, response: ServiceResponse) -> float | None:
        """Ingest one response; returns the windowed p95 (ms) whenever a
        ``req_granularity`` boundary is crossed, else None."""
        self.responses.append(response)
        if response.error_code:
            self.error_counts[response.error_code] = (
                self.error_counts.get(response.error_code, 0) + 1)
        key = (response.epoch, response.batch_id, response.exp_packet)
        j = self._open.get(key)
        if j is None:
            j = QueryJoin(response.arrival_time, response.inference_end_time,
                          response.total_sub_batches)
            self._open[key] = j
        else:
            j.arrival = min(j.arrival, response.arrival_time)
            j.inference_end = max(j.inference_end, response.inference_end_time)
        j.remaining -= 1
        if j.remaining == 0:
            del self._open[key]
            lat = j.inference_end - j.arrival
            self.latencies.append(lat)
            if not response.exp_packet:
                self.final_latencies.append(lat)
            if len(self.latencies) % self.req_granularity == 0:
                window = self.latencies[-self.req_granularity:]
                return float(np.percentile(window, 95) * 1000.0)
        return None

    def measured_qps(self) -> float:
        """QPS over non-experimental whole queries (DeepRecSys.py:168-173)."""
        rs = [r for r in self.responses if (not r.exp_packet) and r.sub_id == 0]
        if len(rs) < 2:
            return 0.0
        span = rs[-1].inference_end_time - rs[0].inference_end_time
        return len(rs) / span if span > 0 else 0.0

    def tail_latency_ms(self, pct: float) -> float:
        if not self.final_latencies:
            return float("nan")
        return float(np.percentile(self.final_latencies, pct) * 1000.0)
