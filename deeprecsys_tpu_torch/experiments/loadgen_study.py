"""Load-generator study: how the query-size distribution moves the tail.

Counterpart of ``deeprecsys_tpu/experiments/loadgen_study.py:30-60``
(reference ``experiments/load_generator/run_loadGenerator.sh``): normal
(avg 165, var 16) against lognormal (mu 5.1, sigma 0.2) query sizes at one
arrival rate through the whole serving stack. The default ``sim`` backend
sleeps over a hand-set latency model (not a measurement of any device);
``--backend gpu`` or ``cpu`` runs real engines.

Usage:
    python -m deeprecsys_tpu_torch.experiments.loadgen_study
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving import run_serving
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel

DISTS = {
    "normal": dict(batch_size_distribution="normal", avg_mini_batch_size=165.0,
                   var_mini_batch_size=16.0),
    "lognormal": dict(batch_size_distribution="lognormal", avg_mini_batch_size=5.1,
                      var_mini_batch_size=0.2),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="query-size distributions against the tail")
    ap.add_argument("--model", default="ncf")
    ap.add_argument("--backend", default="sim", choices=("sim", "gpu", "cpu"))
    ap.add_argument("--arrival-ms", type=float, default=5.0)
    ap.add_argument("--num-batches", type=int, default=128)
    ap.add_argument("--table-scale", type=int, default=1000)
    ap.add_argument("--out", default="build/experiments/loadgen_study.json")
    args = ap.parse_args(argv)

    rows = []
    for name, dist in DISTS.items():
        cfg = ServingConfig(
            num_batches=args.num_batches, nepochs=1, inference_engines=2,
            engine_backend=args.backend, avg_arrival_rate_ms=args.arrival_ms,
            max_mini_batch_size=1024, sub_task_batch_size=64,
            req_granularity=32, seed=7, **dist,
        )
        lm = LatencyModel([1, 64, 1024], [0.2, 0.6, 4.0]) if args.backend == "sim" else None
        res = run_serving(zoo.get_config(args.model, table_scale=args.table_scale),
                          cfg, latency_model=lm, settle_s=0.05)
        if res.engine_errors:
            raise RuntimeError(f"engines failed ({name}): {res.engine_errors}")
        rows.append({"dist": name, "qps": res.measured_qps, "p50_ms": res.p50_ms,
                     "p95_ms": res.p95_ms, "p99_ms": res.p99_ms})
        print(f"{name}: QPS={res.measured_qps:.0f} p50={res.p50_ms:.2f} "
              f"p95={res.p95_ms:.2f} p99={res.p99_ms:.2f} ms", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
