"""The direct lookup against the hot/cold split on a skewed id stream, on
one card.

    python -m deeprecsys_tpu_torch.experiments.skew_bench [--models rm1,rm2,din]
        [--json PATH]

Counterpart of ``deeprecsys_tpu/experiments/skew_bench.py``. The streams
and the hot-set rule are the JAX package's, held equal to it
(``zipf_stream``, ``drifted_zipf_stream``, ``stream_coverage``,
``_hot_set``, ``resolve_auto_impl``): zipf(1.2) ids folded into each
table's rows, rng seed 2, batch 512, bf16, the hot set sized by
``utils/memory.py::suggest_hot_rows``. ``measure_skewed`` is the port's own
and needs a CUDA card (it never falls back to the CPU). For one model it
reports:

- the forward's time a call, direct (K1) and hot/cold (K6 on splits made
  beforehand), from CUDA events around back-to-back calls after a warm-up,
  and each forward's device time from a ``torch.profiler`` trace;
- K1's kernel time on the same zipf ids (the trace's median of the
  kernel) and K6's (the sum of its two launches' medians), and K1's on the
  generator's uniform ids over the same table;
- the host split's time a call (the native splitter with the model's
  ``HotIndex``, host clock, mean over calls);
- the hot set's coverage of the stream and ``embedding_impl="auto"``'s
  choice on it (the JAX package's rule, unchanged);
- ``speedup = direct / max(hot/cold forward, host split)``: what a serving
  engine that splits on its serve thread could gain, at best, over the
  direct lookup.

Each timed loop cycles through ``N_BATCHES`` batches (``measure_skewed``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ZIPF_MODELS = ("rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")


def zipf_stream(cfg, batch: int, alpha: float = 1.2, seed: int = 2) -> np.ndarray:
    """(B, T, L) int32 ids, zipf(alpha) folded into each table's rows
    (JAX :59)."""
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(seed)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    return (rng.zipf(alpha, size=(batch, T, L)) % rows[None, :, None]).astype(np.int32)


def drifted_zipf_stream(cfg, batch: int, alpha: float = 1.2, seed: int = 2,
                        drift_seed: int = 7) -> np.ndarray:
    """The zipf stream after popularity drift: each table's ids remapped by a
    random affine permutation ``a*id + b mod rows`` (JAX :68)."""
    idx = zipf_stream(cfg, batch, alpha=alpha, seed=seed)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(drift_seed)
    out = np.empty_like(idx)
    for t, r in enumerate(rows):
        r = int(r)
        if r <= 1:
            out[:, t, :] = idx[:, t, :]
            continue
        a = int(rng.integers(1, r))
        while math.gcd(a, r) != 1:
            a = a % r + 1
        b = int(rng.integers(0, r))
        out[:, t, :] = ((idx[:, t, :].astype(np.int64) * a + b) % r).astype(np.int32)
    return out


def stream_coverage(cfg, idx: np.ndarray, hot_ids: np.ndarray) -> float:
    """Share of this stream's lookups that ``hot_ids`` (sorted) serves."""
    from deeprecsys_tpu_torch.ops.hotcold import hot_coverage_of

    return hot_coverage_of(idx, np.asarray(cfg.table_offsets), hot_ids)


def _hot_set(cfg, idx: np.ndarray):
    """The hot set of the JAX package's budget for this stream, and its
    coverage."""
    from deeprecsys_tpu_torch.ops.hotcold import select_hot_ids
    from deeprecsys_tpu_torch.utils.memory import suggest_hot_rows

    offs = np.asarray(cfg.table_offsets, dtype=np.int64)
    hot_ids = select_hot_ids(idx, offs, suggest_hot_rows(cfg))
    return hot_ids, stream_coverage(cfg, idx, hot_ids)


def resolve_auto_impl(cfg, idx: np.ndarray):
    """``embedding_impl="auto"``'s decision on this stream: (impl, hot_ids,
    coverage), impl "hotcold" or "xla" (None, None for the ids and coverage
    where the size floor declines unsampled, as an engine does)."""
    if cfg.fused_table_mb < cfg.hotcold_min_table_mb:
        return "xla", None, None
    hot_ids, coverage = _hot_set(cfg, idx)
    if coverage < cfg.hotcold_min_hit:
        return "xla", hot_ids, coverage
    return "hotcold", hot_ids, coverage


def _split_ms(hc, batches) -> float:
    """The host split's time a call (ms, host clock) over ``batches``,
    after one warm-up."""
    hc.prepare(batches[0])
    t0 = time.perf_counter()
    for b in batches:
        hc.prepare(b)
    return (time.perf_counter() - t0) / len(batches) * 1e3


N_BATCHES = 8  # distinct batches a timed loop cycles through: more rows than the 50 MB L2


def measure_skewed(model_name: str, device, batch: int = 512, table_scale: int = 1,
                   alpha: float = 1.2, seed: int = 2, iters: int = 50) -> dict:
    """One model's direct and hot/cold forwards on zipf streams (bf16),
    their lookups' kernels, the host split and ``auto``'s choice (see the
    module docstring). The hot set and ``auto``'s choice come from
    ``zipf_stream(cfg, batch, alpha, seed)``, the JAX package's stream; the
    timed loops cycle through it and the streams of the next
    ``N_BATCHES - 1`` seeds, so the zipf tail comes from device memory as
    in a real stream while the head may stay in the L2. Raises without a
    CUDA ``device``."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.kernel_bench import measure
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.models.base import Batch, table_offsets
    from deeprecsys_tpu_torch.models.hotcold import make_hotcold_model
    from deeprecsys_tpu_torch.ops.embedding import embedding_bag, embedding_bag_hotcold
    from deeprecsys_tpu_torch.ops.hotcold import _split_hot_cold_native

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_skewed times the card; {device} is not a CUDA card")
    cfg = zoo.get_config(model_name, table_scale=table_scale, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    streams = [zipf_stream(cfg, batch, alpha=alpha, seed=seed + i) for i in range(N_BATCHES)]
    gen = RecDataGenerator(cfg, seed=0)
    hosts = [gen.generate_batch(batch) for _ in range(N_BATCHES)]
    chosen, _, _ = resolve_auto_impl(cfg, streams[0])
    hot_ids, coverage = _hot_set(cfg, streams[0])
    model = get_model(cfg, device)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        hc = make_hotcold_model(model, hot_ids)
        hparams = hc.convert_params(params)
        host_batches = [Batch(dense=h.dense, indices=i) for h, i in zip(hosts, streams)]
        calls0 = _split_hot_cold_native.calls
        split_ms = _split_ms(hc, host_batches)
        if _split_hot_cold_native.calls == calls0:
            raise RuntimeError("the host split did not take the native splitter")
        splits = [hc.prepare(b) for b in host_batches]
        args = []
        for h, i, sp in zip(hosts, streams, splits):
            dev = Batch(None if h.dense is None else torch.from_numpy(h.dense).to(device),
                        torch.from_numpy(i).to(device))
            dev_split = {k: torch.from_numpy(np.ascontiguousarray(sp[k])).to(device)
                         for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}
            args.append((dev, dev_split))
        uniform = [(torch.from_numpy(h.indices).to(device),) for h in hosts]
        offsets = table_offsets(cfg, device)
        table, hot = params["tables"], hparams["hot_table"]
        runs = {
            "xla": measure(lambda b, s: model.apply(params, b), args, iters),
            "hotcold": measure(lambda b, s: hc.apply(hparams, b, s), args, iters),
            "k1": measure(lambda b, s: embedding_bag(table, offsets, b.indices), args, iters),
            "k6": measure(lambda b, s: embedding_bag_hotcold(hot, table, s), args, iters),
            "k1_uniform": measure(lambda i: embedding_bag(table, offsets, i), uniform, iters),
        }
    xla_ms, hc_ms = runs["xla"]["wall_ms"], runs["hotcold"]["wall_ms"]
    out = {"model": model_name, "batch": batch, "alpha": alpha, "seed": seed,
           "table_scale": table_scale, "hot_rows": int(len(hot_ids)),
           "hot_coverage": float(coverage),
           "hot_coverage_streams": float(np.mean([stream_coverage(cfg, i, hot_ids)
                                                  for i in streams])),
           "auto_impl": chosen, "n_cold": int(splits[0]["n_cold"]),
           "c_pad": int(splits[0]["cold_ids"].size), "xla_ms": xla_ms, "hotcold_ms": hc_ms,
           "xla_device_ms": runs["xla"]["device_ms"],
           "hotcold_device_ms": runs["hotcold"]["device_ms"],
           "k1_ms": runs["k1"]["kernel_ms"], "k6_ms": runs["k6"]["launch_sum_ms"],
           "k1_uniform_ms": runs["k1_uniform"]["kernel_ms"], "split_ms": split_ms,
           "speedup": xla_ms / max(hc_ms, split_ms),
           # Device µs a call by kernel, each run's three largest.
           "by_kernel": {k: dict(sorted(r["us_by_kernel"].items(), key=lambda kv: -kv[1])[:3])
                         for k, r in runs.items()}}
    del params, hparams, table, hot, hc, args
    torch.cuda.empty_cache()
    return out


def line(r: dict, card: str) -> str:
    """One model's result as one line."""
    def us(ms):
        return "not measured" if ms is None else f"{ms * 1e3:.2f} us"

    return (f"{r['model']} zipf({r['alpha']}) seed {r['seed']} batch {r['batch']} bf16: "
            f"forward direct {us(r['xla_ms'])} (device {us(r['xla_device_ms'])}), hot/cold "
            f"{us(r['hotcold_ms'])} (device {us(r['hotcold_device_ms'])}); K1 {us(r['k1_ms'])} "
            f"(uniform ids {us(r['k1_uniform_ms'])}), K6 {us(r['k6_ms'])}; host split "
            f"{r['split_ms']:.3f} ms a call (native, HotIndex); coverage "
            f"{r['hot_coverage']:.4f} of {r['hot_rows']} hot rows (over {N_BATCHES} seeds' "
            f"streams {r['hot_coverage_streams']:.4f}; {r['n_cold']} cold of "
            f"C_pad {r['c_pad']}); auto picks {r['auto_impl']}; direct / max(hot/cold, "
            f"split) = {r['speedup']:.4f} [{card}]")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--models", type=str, default="rm1,rm2,din")
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("skew_bench: no CUDA card is available", file=sys.stderr)
        return 1
    from deeprecsys_tpu_torch.kernel_bench import card_line

    card = card_line()
    rows = []
    for name in args.models.split(","):
        rows.append(measure_skewed(name, torch.device("cuda")))
        print(f"[skew_bench] {line(rows[-1], card)}", flush=True)
        print(f"[skew_bench] {name} device us a call by kernel: {rows[-1]['by_kernel']}",
              flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "models": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
