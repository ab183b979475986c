"""Scheduler study: DeepRecSched's convergence across seeds and modes.

Counterpart of ``deeprecsys_tpu/experiments/scheduling_study.py:27-153``
(reference ``experiments/scheduling/run_Scheduler.sh``: seeds x {CPU-only
batch tuning, CPU + accelerator tuning}, comparing the tuned operating
points). The default backend is ``sim`` over two hand-set latency models
(not measurements of any device: a host path near linear in the batch, an
offload path flat until large), so the study exercises the scheduler
alone; ``--backend gpu`` or ``cpu`` studies real engines, the offload
engine then on ``--device`` (the card unless ``cpu`` is asked for).

Usage:
    python -m deeprecsys_tpu_torch.experiments.scheduling_study --seeds 3
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving import run_serving
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel


def run_study(model_name: str, seeds: int, tune_accel: bool, backend: str,
              table_scale: int, quick: bool, ref_regime: bool = False,
              accel_device: str = "cuda") -> list[dict]:
    results = []
    for seed in range(seeds):
        if ref_regime:
            # The reference's own study design (run_Scheduler.sh): 32
            # engines, lognormal(5.1, 0.2) query sizes, the 9-entry batch
            # ladder, arrivals 1-20 ms in 50 log steps, 128 x 32 queries.
            cfg = ServingConfig(
                num_batches=32, nepochs=128, inference_engines=32, engine_backend=backend,
                avg_arrival_rate_ms=2.0, batch_size_distribution="lognormal",
                avg_mini_batch_size=5.1, var_mini_batch_size=0.2, max_mini_batch_size=1024,
                sub_task_batch_size=64, req_granularity=64, target_latency_ms=25.0,
                tune_batch_qps=True, tune_accel_qps=tune_accel, model_accel=tune_accel,
                batch_configs=(512, 384, 256, 192, 128, 96, 64, 48, 32),
                accel_configs=(96, 128, 192, 256, 384, 512), arr_steps=50,
                sched_timeout=128, min_arr_range=1.0, max_arr_range=20.0, seed=seed)
        else:
            cfg = ServingConfig(
                num_batches=64 if quick else 256, nepochs=1, inference_engines=2,
                engine_backend=backend, avg_arrival_rate_ms=2.0,
                batch_size_distribution="normal", avg_mini_batch_size=165.0,
                var_mini_batch_size=16.0, max_mini_batch_size=1024, sub_task_batch_size=64,
                req_granularity=16 if quick else 64, target_latency_ms=25.0,
                tune_batch_qps=True, tune_accel_qps=tune_accel, model_accel=tune_accel,
                batch_configs=(512, 256, 128, 64, 32),
                accel_configs=(96, 128, 192, 256, 384, 512),
                arr_steps=6 if quick else 20, sched_timeout=8 if quick else 64,
                min_arr_range=0.5, max_arr_range=16.0, seed=seed)
        model_cfg = zoo.get_config(model_name, table_scale=table_scale)
        lm = accel_lm = None
        if backend == "sim":
            # Host path: near linear in the batch; offload path: flat until large.
            lm = LatencyModel([1, 32, 256, 1024], [0.3, 0.8, 4.0, 15.0])
            accel_lm = LatencyModel([1, 1024], [1.0, 2.0])
        res = run_serving(model_cfg, cfg, latency_model=lm, accel_latency_model=accel_lm,
                          settle_s=0.05, accel_device=accel_device)
        if res.engine_errors:
            raise RuntimeError(f"engines failed (seed {seed}): {res.engine_errors}")
        results.append({
            "seed": seed,
            "tune_accel": tune_accel,
            "optimal_sub_batch": res.optimal_sub_batch,
            "optimal_accel_thres": res.optimal_accel_thres,
            "qps": res.measured_qps,
            "p95_ms": res.p95_ms,
        })
        print(f"seed={seed} accel={tune_accel}: sub_batch={res.optimal_sub_batch} "
              f"accel_thres={res.optimal_accel_thres} qps={res.measured_qps:.0f} "
              f"p95={res.p95_ms:.1f}ms", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="DeepRecSched across seeds and modes")
    ap.add_argument("--model", default=None,
                    help="default: ncf (wnd with --ref-regime, the reference script's)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--backend", default="sim", choices=("sim", "gpu", "cpu"))
    ap.add_argument("--table-scale", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="the offload engine's device with --backend gpu or cpu ('cuda' raises "
                         "without a card)")
    ap.add_argument("--full", action="store_true", help="reference-scale run")
    ap.add_argument("--ref-regime", action="store_true",
                    help="the reference's study design: 32 engines, lognormal(5.1,0.2) "
                         "queries, the 9-entry batch ladder (run_Scheduler.sh)")
    ap.add_argument("--out", default="build/experiments/scheduling_study.json")
    args = ap.parse_args(argv)
    if args.model is None:
        args.model = "wnd" if args.ref_regime else "ncf"
    rows = []
    for tune_accel in (False, True):
        rows += run_study(args.model, args.seeds, tune_accel, args.backend, args.table_scale,
                          quick=not args.full, ref_regime=args.ref_regime,
                          accel_device=args.device)
    if not rows:
        raise SystemExit("study produced no rows; output left untouched")
    new = [dict(r, ref_regime=args.ref_regime, model=args.model) for r in rows]

    def key(r):
        return bool(r["ref_regime"]), r["model"]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():  # this run replaces its own (regime, model) rows only
        new = [r for r in json.loads(out.read_text()) if key(r) != key(new[0])] + new
    out.write_text(json.dumps(new, indent=2))
    return new


if __name__ == "__main__":
    main()
