"""Latency-bounded QPS: the DeepRecSys headline metric.

Counterpart of ``deeprecsys_tpu/experiments/qps_sweep.py:35-111``. Sweeps
Poisson arrival rates (log-spaced) through the whole serving stack at query
sizes ~N(165, 16) and reports the largest measured QPS whose p95 meets the
SLA (reference README.md:59, DeepRecSys.py:173-175).

Backends: ``gpu`` (compute engines on the card), ``cpu`` (on the host) and
``calibrated-sim``: sim engines sleeping over the card's own latency ladder
``gpu_<model>.json`` in ``CHAR_DIR`` (``serving/latency_model.py``;
``experiments/sweep.py`` measures it), the reference's accelerator
simulation fed with the card's characterization. No other ladder stands
in: without the card's file ``calibrated-sim`` raises.

Usage:
    python -m deeprecsys_tpu_torch.experiments.qps_sweep --model rm1 --backend gpu \\
        --sla-ms 25
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving import run_serving
from deeprecsys_tpu_torch.serving.latency_model import load_card_ladder

BACKENDS = ("gpu", "cpu", "calibrated-sim")


def serving_config(backend: str, sla_ms: float, arrival_ms: float, engines: int,
                   num_batches: int, sub_batch: int) -> ServingConfig:
    """The serving run of one arrival rate: sizes ~N(165, 16) capped at
    1024, split into sub-batches of ``sub_batch``."""
    return ServingConfig(
        num_batches=num_batches, nepochs=1, inference_engines=engines,
        engine_backend=backend, avg_arrival_rate_ms=float(arrival_ms),
        batch_size_distribution="normal", avg_mini_batch_size=165.0,
        var_mini_batch_size=16.0, max_mini_batch_size=1024,
        sub_task_batch_size=sub_batch, req_granularity=32,
        target_latency_ms=sla_ms, seed=13,
    )


def sweep(model: str, backend: str, sla_ms: float, arrivals_ms, engines: int,
          num_batches: int, table_scale: int, sub_batch: int) -> dict:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (valid: {BACKENDS})")
    lm = None
    eff_backend = backend
    if backend == "calibrated-sim":
        lm, _ = load_card_ladder(model)
        eff_backend = "sim"
    rows = []
    best = None
    for arr in arrivals_ms:
        cfg = serving_config(eff_backend, sla_ms, arr, engines, num_batches, sub_batch)
        res = run_serving(zoo.get_config(model, table_scale=table_scale,
                                         param_dtype="bfloat16", compute_dtype="bfloat16"),
                          cfg, latency_model=lm, settle_s=0.05)
        if res.engine_errors:
            raise RuntimeError(f"engines failed at arrival {arr} ms: {res.engine_errors}")
        meets = res.p95_ms <= sla_ms
        rows.append({"arrival_ms": float(arr), "qps": res.measured_qps,
                     "p95_ms": res.p95_ms, "p99_ms": res.p99_ms, "meets_sla": meets})
        print(f"arrival={arr:.2f}ms QPS={res.measured_qps:8.1f} "
              f"p95={res.p95_ms:7.2f}ms {'OK' if meets else 'VIOLATES'}", flush=True)
        if meets and (best is None or res.measured_qps > best["qps"]):
            best = rows[-1]
    return {"model": model, "backend": backend, "sla_ms": sla_ms,
            "engines": engines, "sub_batch": sub_batch, "table_scale": table_scale,
            "sweep": rows, "latency_bounded_qps": best["qps"] if best else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser(description="latency-bounded QPS")
    ap.add_argument("--model", default="rm1")
    ap.add_argument("--backend", default="gpu", choices=BACKENDS)
    ap.add_argument("--sla-ms", type=float, default=25.0)
    # One engine thread: on the card several share one interpreter's GIL
    # (main.py warns of it).
    ap.add_argument("--engines", type=int, default=1)
    ap.add_argument("--num-batches", type=int, default=96)
    ap.add_argument("--table-scale", type=int, default=1)
    ap.add_argument("--sub-batch", type=int, default=256)
    ap.add_argument("--min-arr", type=float, default=0.3)
    ap.add_argument("--max-arr", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="build/experiments/qps_sweep.json")
    args = ap.parse_args(argv)
    arrivals = np.logspace(np.log10(args.min_arr), np.log10(args.max_arr), args.steps)
    result = sweep(args.model, args.backend, args.sla_ms, arrivals, args.engines,
                   args.num_batches, args.table_scale, args.sub_batch)
    print(f"latency-bounded QPS ({args.model}, {args.backend}, p95<={args.sla_ms}ms): "
          f"{result['latency_bounded_qps']:.1f}")
    out = Path(args.out)
    existing = json.loads(out.read_text()) if out.exists() else {}
    existing[f"{args.model}:{args.backend}"] = result
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(existing, indent=2))
    return result


if __name__ == "__main__":
    main()
