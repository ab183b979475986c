"""The calibrated sim against the real engine, both on this machine.

    python -m deeprecsys_tpu_torch.tools.sim_revalidate [--sensitivity] [--device cuda|cpu]
        [--ladder-dir DIR] [--table-scale N] [--num-batches 64] [--out PATH] [model ...]

Counterpart of ``tools/sim_revalidate.py:36-144``. The JAX tool reruns
only the sim half, against serving runs recorded on a TPU and a floor
fitted to its relay. This one runs both halves here, at the same operating
point (``mk_cfg``: seed 3, arrivals 60 ms apart, sizes ~N(165, 16) capped
at 1024, sub-batches of 64, buckets 64-1024, one engine):

- the real half: ``run_serving`` with compute engines on the card
  (``engine_backend="gpu"``; ``--device cpu``: ``"cpu"``, a rehearsal);
- the sim half: ``engine_backend="sim"`` over the card's own latency
  ladder (``serving/latency_model.py::load_card_ladder``,
  ``characterization/gpu_<model>.json``, as ``qps_sweep --backend
  calibrated-sim`` reads it), which launches no kernel.

The real half's model takes the ladder's own ``table_scale`` and dtype
(``--table-scale`` overrides the scale, for a CPU rehearsal). The record
holds both halves and the sim's relative errors. ``--sensitivity`` instead
scales every latency of the ladder by 0.90-1.10 and records how the sim's
p50/p95 move (the JAX tool scales its relay floor; the card has no relay
floor, so the ladder is what is scaled, and the record says so). At 60 ms
arrivals the card is far from saturation, so little amplification is
expected: queueing delay is what amplifies a service-time error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving import latency_model, run_serving
from deeprecsys_tpu_torch.serving.latency_model import (
    LatencyModel, card_ladder_path, load_card_ladder)
from deeprecsys_tpu_torch.tools.common import (
    card_of, default_out, device_arg, write_record)
from deeprecsys_tpu_torch.utils.devices import resolve_device

SCALES = (0.90, 0.95, 1.0, 1.05, 1.10)


def mk_cfg(engine_backend: str = "sim", num_batches: int = 64) -> ServingConfig:
    """The sim-validation operating point (the JAX tool's ``mk_cfg``)."""
    return ServingConfig(
        num_batches=num_batches, nepochs=1, inference_engines=1,
        engine_backend=engine_backend, avg_arrival_rate_ms=60.0,
        batch_size_distribution="normal", avg_mini_batch_size=165.0,
        var_mini_batch_size=16.0, max_mini_batch_size=1024,
        sub_task_batch_size=64, batch_buckets=(64, 128, 256, 512, 1024),
        req_granularity=16, target_latency_ms=25.0, seed=3,
    )


def ladder(model: str, ladder_dir=None) -> tuple[LatencyModel, dict]:
    """The card's ladder for ``model`` and its fields, from ``ladder_dir``
    (default ``latency_model.CHAR_DIR``)."""
    if ladder_dir is None:
        return load_card_ladder(model)
    path = Path(ladder_dir) / card_ladder_path(model).name
    if not path.exists():
        raise FileNotFoundError(f"no card ladder {path}")
    fields = json.loads(path.read_text())
    return LatencyModel.from_json(fields), fields


def model_config(model: str, fields: dict, table_scale: int = 0):
    dtype = fields.get("dtype", "bfloat16")
    return zoo.get_config(model, table_scale=table_scale or int(fields.get("table_scale", 1)),
                          param_dtype=dtype, compute_dtype=dtype)


def _summary(res) -> dict:
    return {"qps": res.measured_qps, "p50_ms": res.p50_ms, "p95_ms": res.p95_ms,
            "n": res.num_responses, "executions": res.executions}


def _served(res, what: str):
    if res.engine_errors or res.error_responses:
        raise RuntimeError(f"{what}: errors {res.error_responses} {res.engine_errors}")
    return res


def real_half(m_cfg, device, num_batches: int = 64) -> dict:
    backend = "gpu" if device.type == "cuda" else "cpu"
    res = _served(run_serving(m_cfg, mk_cfg(backend, num_batches), settle_s=0.05),
                  f"the real half on {device}")
    return {**_summary(res), "engine_backend": backend}


def sim_half(m_cfg, lm: LatencyModel, num_batches: int = 64) -> dict:
    res = _served(run_serving(m_cfg, mk_cfg("sim", num_batches), latency_model=lm,
                              settle_s=0.05), "the sim half")
    return _summary(res)


def _rel(sim: float, real: float) -> float:
    return (sim - real) / max(real, 1e-9)


def revalidate(model: str, device, ladder_dir=None, table_scale: int = 0,
               num_batches: int = 64, card: str = "") -> dict:
    lm, fields = ladder(model, ladder_dir)
    m_cfg = model_config(model, fields, table_scale)
    real = real_half(m_cfg, device, num_batches)
    sim = sim_half(m_cfg, lm, num_batches)
    out = {"model": model, "table_scale": m_cfg.table_scale, "dtype": m_cfg.param_dtype,
           "ladder": {k: fields.get(k) for k in ("device", "power_limit", "table_scale",
                                                  "dtype", "batch_sizes", "latencies_ms")},
           "sim_model": "the card's ladder as measured (qps_sweep --backend calibrated-sim)",
           "real": real, "sim": sim,
           "p95_rel_err": _rel(sim["p95_ms"], real["p95_ms"]),
           "p50_rel_err": _rel(sim["p50_ms"], real["p50_ms"]),
           "qps_rel_err": _rel(sim["qps"], real["qps"])}
    print(f"{model}: sim QPS {sim['qps']:.2f} p50 {sim['p50_ms']:.3f} p95 {sim['p95_ms']:.3f} "
          f"vs real QPS {real['qps']:.2f} p50 {real['p50_ms']:.3f} p95 {real['p95_ms']:.3f} "
          f"-> p95 err {out['p95_rel_err']:+.1%}, p50 err {out['p50_rel_err']:+.1%}, "
          f"qps err {out['qps_rel_err']:+.1%} [{card}]", flush=True)
    return out


def sensitivity(model: str, device, ladder_dir=None, table_scale: int = 0,
                num_batches: int = 64, card: str = "", scales=SCALES) -> dict:
    lm, fields = ladder(model, ladder_dir)
    m_cfg = model_config(model, fields, table_scale)
    real = real_half(m_cfg, device, num_batches)
    rows = []
    for s in scales:
        scaled = LatencyModel(lm.batches, lm.lat_ms * s, base=lm.base)
        sim = sim_half(m_cfg, scaled, num_batches)
        rows.append({"ladder_scale": s, "qps": sim["qps"], "p50_ms": sim["p50_ms"],
                     "p95_ms": sim["p95_ms"]})
        print(f"{model} ladder x{s:.2f}: qps {sim['qps']:.2f} p50 {sim['p50_ms']:.3f} "
              f"p95 {sim['p95_ms']:.3f} [{card}]", flush=True)
    mid = next(r for r in rows if r["ladder_scale"] == 1.0)
    lo, hi = rows[0], rows[-1]
    amp = ((hi["p95_ms"] - lo["p95_ms"]) / max(mid["p95_ms"], 1e-9)
           / (hi["ladder_scale"] - lo["ladder_scale"]))
    return {"model": model, "scaled": "the card's ladder: every latency times ladder_scale",
            "real": real, "sweep": rows, "p95_amplification_per_unit_scale": amp}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("models", nargs="*", help="default: every model with a card ladder")
    ap.add_argument("--sensitivity", action="store_true")
    device_arg(ap)
    ap.add_argument("--ladder-dir", default=None, help="default: the characterization/ ladders")
    ap.add_argument("--table-scale", type=int, default=0, help="0 = the ladder's")
    ap.add_argument("--num-batches", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)
    ladder_dir = Path(args.ladder_dir or latency_model.CHAR_DIR)
    models = args.models or sorted(p.stem[len("gpu_"):] for p in ladder_dir.glob("gpu_*.json"))
    kw = dict(ladder_dir=args.ladder_dir, table_scale=args.table_scale,
              num_batches=args.num_batches, card=card)
    head = {"device": str(device), "card": card, "operating_point": dataclasses.asdict(mk_cfg())}
    if args.sensitivity:
        results = {m: sensitivity(m, device, **kw) for m in models}
        amps = {m: r["p95_amplification_per_unit_scale"] for m, r in results.items()}
        print(f"p95 amplification (relative p95 change per relative ladder change): {amps} "
              f"[{card}]", flush=True)
        out = args.out or default_out("sim_sensitivity")
    else:
        results = {m: revalidate(m, device, **kw) for m in models}
        errs = [abs(r["p95_rel_err"]) for r in results.values()]
        print(f"p95 within 25%: {sum(e <= 0.25 for e in errs)}/{len(errs)}; max |err| "
              f"{max(errs):.1%} [{card}]", flush=True)
        out = args.out or default_out("sim_validation")
    record = {**head, "results": results}
    write_record(out, record)
    return record


if __name__ == "__main__":
    main()
