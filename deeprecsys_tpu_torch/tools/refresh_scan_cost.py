"""The hot/cold refresh's candidate-scan cost, capped and uncapped.

    python -m deeprecsys_tpu_torch.tools.refresh_scan_cost [--models rm1,rm2,rm3,din]
        [--table-scale 1] [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/refresh_scan_cost.py:48-103``. An engine's refresh
or upgrade scan (``serving/engine.py``'s candidate scan on its scan
worker) runs one ``select_hot_ids`` (a sort-unique over the buffered
window) and one holdout coverage pass. For each gather-bound model, at
the engine-shaped window (16 batches of 512 rows of zipf(1.2) ids) and the
hot set ``utils/memory.py::suggest_hot_rows`` sizes, this records:

- the uncapped scan's host time;
- its time under ``hotcold_scan_budget``'s row-stride cap (2,000,000
  lookups, the ``ServingConfig`` default);
- the holdout coverage of the uncapped set, and of the capped set on the
  same full holdout: the cap must not degrade the head it selects.

The scan is numpy on the host by nature, as the JAX tool's is: no device
work is involved, and nothing falls back. ``--device`` names the machine
the record belongs to (``cuda``, the default, raises without a card).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.ops.hotcold import (
    hot_coverage_of, scan_budget_subsample, select_hot_ids)
from deeprecsys_tpu_torch.tools.common import (
    card_of, default_out, device_arg, write_record)
from deeprecsys_tpu_torch.utils.devices import resolve_device
from deeprecsys_tpu_torch.utils.memory import suggest_hot_rows

WINDOW, BATCH = 16, 512
BUDGET = 2_000_000  # the ServingConfig.hotcold_scan_budget default
MODELS = ("rm1", "rm2", "rm3", "din")


def model_config(model: str, table_scale: int = 1):
    return zoo.get_config(model, table_scale=table_scale, param_dtype="bfloat16")


def window(cfg) -> list:
    """The engine-shaped window: WINDOW batches of BATCH rows of zipf(1.2)
    ids folded into each table's rows (rng seed 0, as the JAX tool)."""
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    rows = np.asarray(cfg.scaled_rows, np.int64)
    rng = np.random.default_rng(0)
    return [(rng.zipf(1.2, size=(BATCH, T, L)) % rows[None, :, None]).astype(np.int32)
            for _ in range(WINDOW)]


def scan_window(cfg, batches: list) -> dict:
    """Both scans of ``batches``: the selection on all but the last quarter,
    the coverage on that holdout. Returns each scan's hot set, coverage and
    host ms, and the capped set's coverage of the full holdout."""
    offs = np.asarray(cfg.table_offsets)
    k = suggest_hot_rows(cfg)
    n_hold = max(1, WINDOW // 4)
    sel_full = np.concatenate(batches[:-n_hold], axis=0)
    hold_full = np.concatenate(batches[-n_hold:], axis=0)

    def scan(sel, hold):
        t0 = time.perf_counter()
        hot = select_hot_ids(sel, offs, k)
        t1 = time.perf_counter()
        cov = hot_coverage_of(hold, offs, hot)
        t2 = time.perf_counter()
        return hot, cov, (t1 - t0) * 1e3 + (t2 - t1) * 1e3

    hot_u, cov_u, ms_u = scan(sel_full, hold_full)
    hot_c, _, ms_c = scan(scan_budget_subsample(sel_full, BUDGET),
                          scan_budget_subsample(hold_full, BUDGET))
    return {"k": int(k), "lookups": int(sel_full.size), "hot_uncapped": hot_u,
            "hot_capped": hot_c, "coverage_uncapped": float(cov_u),
            "coverage_capped_full_holdout": float(hot_coverage_of(hold_full, offs, hot_c)),
            "uncapped_ms": ms_u, "capped_ms": ms_c}


def measure(model: str, table_scale: int = 1, card: str = "") -> dict:
    cfg = model_config(model, table_scale)
    s = scan_window(cfg, window(cfg))
    out = {
        "window": WINDOW, "batch": BATCH, "lookups_scanned_M": s["lookups"] / 1e6,
        "hot_rows_k": s["k"], "uncapped_ms": s["uncapped_ms"], "capped_ms": s["capped_ms"],
        "budget": BUDGET, "coverage_uncapped_set": s["coverage_uncapped"],
        "coverage_capped_set_full_holdout": s["coverage_capped_full_holdout"],
    }
    print(f"{model}: {out['lookups_scanned_M']:.2f}M ids; uncapped {out['uncapped_ms']:.1f} ms "
          f"-> capped {out['capped_ms']:.1f} ms; holdout coverage "
          f"{out['coverage_uncapped_set']:.4f} (uncapped set) vs "
          f"{out['coverage_capped_set_full_holdout']:.4f} (capped set) [{card}]", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--table-scale", type=int, default=1)
    device_arg(ap)
    ap.add_argument("--out", default=str(default_out("refresh_scan_cost")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)
    results = {m: measure(m, args.table_scale, card) for m in args.models.split(",")}
    record = {"note": "the refresh's candidate-scan host cost; the cap is "
                      "ServingConfig.hotcold_scan_budget's row-stride subsample",
              "device": str(device), "card": card, "table_scale": args.table_scale,
              "results": results}
    path = write_record(args.out, record)
    print(f"[refresh_scan_cost] [{card}] -> {path}", flush=True)
    return record


if __name__ == "__main__":
    main()
