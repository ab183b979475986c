"""This checkout's K5 window and K6 shard calls timed in turns with another
checkout's (an earlier commit, unpacked with ``git archive``), on one card.

    python -m deeprecsys_tpu_torch.experiments.parent_turns --other DIR [--json PATH]

Runs this file as a child four times, in the order other, this, this,
other, each with ``PYTHONPATH`` set to its checkout, so that each child
imports and builds that checkout's package and nothing else. A child
times, with CUDA events (each call queued behind a spin kernel; the median
span of 50 calls):

- K5's window, ``sparse_adagrad_step_shard``, on shard 1 of M of rm1's
  table (M 4 and 2) and of rm2's (M 4), f32 and bf16 shards, at the
  trainer's batch (128, eight batches of ids);
- K6 on a shard of the 1x4 hot/cold mesh, rm1 and rm2, the three layouts:
  shard 0 with the hot hits, and shard 1 as its checkout's mesh path calls
  it: ``--route cold`` the cold-only route (``shard`` given no hot rows),
  ``--route mask`` K6 with an all-false hot mask (the call of a checkout
  without that route). The hot set is fitted on a warm-up zipf(1.2) batch
  of 512 and the calls take four later batches.

Each call is held first to ``embedding_bag_hotcold_reference(...,
partial=True)`` with the mask it stands for (int8 bit for bit, else within
``hotcold_tolerance``), and K5's to its plain version
(``sparse_adagrad_tolerance``). It uses only functions that every checkout
since the mesh port has. It needs a CUDA card and exits non-zero without
one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

K5_CELLS = (("rm1", 4), ("rm1", 2), ("rm2", 4))
K6_MODELS = ("rm1", "rm2")
K6_LAYOUTS = ("none", "int8", "int8_rowwise")
SHARDS = 4
BATCH = 512


def span_ms(fn, args_list, iters: int = 50) -> float:
    for a in args_list:
        fn(*a)
    pairs = []
    for i in range(iters):
        torch.cuda._sleep(200_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args_list[i % len(args_list)])
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def k5_rows(device) -> list:
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops import sparse_adagrad_step_shard
    from deeprecsys_tpu_torch.ops.sparse_adagrad import (
        sparse_adagrad_step_reference, sparse_adagrad_tolerance)

    rows = []
    for name, M in K5_CELLS:
        cfg = zoo.get_config(name)
        rps = cfg.total_rows // M
        lo, d = rps, cfg.sparse_feature_size
        offsets = table_offsets(cfg, device)
        g = torch.Generator(device=device).manual_seed(15)
        ids = [b.to(device).indices for b in
               RecDataGenerator(cfg, seed=13).generate_batches(8, 128)]
        gs = [torch.randn((128, cfg.num_tables, d), generator=g, device=device) * 1e-2
              for _ in ids]
        for dt in (torch.float32, torch.bfloat16):
            shard = ((torch.rand((rps, d), generator=g, device=device) - 0.5) * 0.1).to(dt)
            acc = torch.zeros((rps,), dtype=torch.float32, device=device)
            got_t, got_a, want_t, want_a = shard.clone(), acc.clone(), shard.clone(), acc.clone()
            sparse_adagrad_step_shard(got_t, got_a, offsets, ids[0], gs[0], lo, 0.1)
            sparse_adagrad_step_reference(want_t, want_a, offsets, ids[0], gs[0], 0.1,
                                          window=(lo, lo + rps))
            tol, acc_tol = sparse_adagrad_tolerance(shard, acc, offsets, ids[0], gs[0], 0.1,
                                                    window=(lo, lo + rps))
            if not (bool(((got_t.float() - want_t.float()).abs() <= tol).all())
                    and bool(((got_a - want_a).abs() <= acc_tol).all())):
                raise AssertionError(f"K5's window disagrees with its plain version ({name} "
                                     f"1/{M}, {dt})")
            del got_t, got_a, want_t, want_a, tol, acc_tol
            ms = span_ms(lambda gr, i: sparse_adagrad_step_shard(shard, acc, offsets, i, gr, lo,
                                                                 0.1), list(zip(gs, ids)))
            rows.append({"kernel": "K5 window", "model": name, "shard": f"1/{M}",
                         "dtype": str(dt)[6:], "span_ms": ms})
            print(f"[parent_turns] K5 window {name} 1/{M} {dt}: span {ms * 1e3:.2f} us",
                  flush=True)
            del shard, acc
            torch.cuda.empty_cache()
    return rows


def k6_rows(device, route: str) -> list:
    import types

    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.experiments.skew_bench import _hot_set, zipf_stream
    from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
    from deeprecsys_tpu_torch.ops import embedding as emb
    from deeprecsys_tpu_torch.ops.hotcold import split_hot_cold_sharded

    rows = []
    for name in K6_MODELS:
        cfg = zoo.get_config(name, param_dtype="bfloat16", compute_dtype="bfloat16")
        R, d = cfg.total_rows, cfg.sparse_feature_size
        rps = R // SHARDS
        hot_ids, _ = _hot_set(cfg, zipf_stream(cfg, BATCH, seed=22))
        offs = np.asarray(cfg.table_offsets, dtype=np.int64)
        mesh = types.SimpleNamespace(shape={"data": 1, "model": SHARDS})
        splits = []
        for i in range(4):
            idx = zipf_stream(cfg, BATCH, seed=23 + i)
            sp = split_hot_cold_sharded(idx, offs, hot_ids, SHARDS, rps,
                                        cold_buckets=cold_buckets_for(idx.size, mesh),
                                        impl="native")
            on = {k: torch.from_numpy(np.ascontiguousarray(sp[k])).to(device)
                  for k in ("hot_sel", "hot_mask", "cold_local", "cold_seg")}
            splits.append([{"hot_sel": on["hot_sel"], "cold_ids": on["cold_local"][m].contiguous(),
                            "cold_seg": on["cold_seg"][m].contiguous(),
                            "hot_mask": on["hot_mask"] if m == 0 else
                            torch.zeros_like(on["hot_mask"])} for m in (0, 1)])
        for quant in K6_LAYOUTS:
            g = torch.Generator(device=device).manual_seed(1)
            if quant == "none":
                table = torch.empty((R, d), dtype=torch.bfloat16, device=device).uniform_(
                    -0.05, 0.05, generator=g)
            else:
                table = torch.randint(-127, 128, (R, d + (4 if quant == "int8_rowwise" else 0)),
                                      generator=g, device=device, dtype=torch.int8)
                if quant == "int8_rowwise":
                    sc = torch.rand((R,), generator=g, device=device) * 1e-2 + 1e-4
                    table[:, d:] = sc.view(torch.int8).reshape(R, 4)
            hot = table.index_select(0, torch.as_tensor(hot_ids, device=device))
            wrap = {"none": emb.embedding_bag_hotcold_shard,
                    "int8": emb.embedding_bag_hotcold_int8_shard,
                    "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[quant]
            kw = {"compute_dtype": torch.bfloat16} if quant == "none" else {}
            for m in (0, 1):
                shard = table[m * rps:(m + 1) * rps]
                if m == 1 and route == "cold":
                    B, T, _ = splits[0][1]["hot_sel"].shape

                    def call(s, shard=shard, B=B, T=T):
                        return wrap(None, shard, {"cold_ids": s["cold_ids"],
                                                  "cold_seg": s["cold_seg"], "bags": (B, T)}, **kw)
                else:
                    def call(s, shard=shard):
                        return wrap(hot, shard, s, **kw)
                s0 = splits[0][m]
                got = call(s0)
                if quant == "none":
                    want = emb.embedding_bag_hotcold_reference(hot, shard, s0, partial=True,
                                                               compute_dtype=torch.bfloat16)
                elif quant == "int8":
                    want = emb.embedding_bag_hotcold_int8_reference(hot, shard, None, s0,
                                                                    partial=True)
                else:
                    want = emb.embedding_bag_hotcold_int8_rowwise_reference(hot, shard, s0,
                                                                            partial=True)
                ok = (torch.equal(got, want) if quant == "int8" else bool(
                    ((got - want).abs() <= emb.hotcold_tolerance(
                        got, want, hot, shard, s0, rowwise=quant == "int8_rowwise")).all()))
                if not ok:
                    raise AssertionError(f"K6 on shard {m} disagrees ({name} {quant})")
                ms = span_ms(call, [(s[m],) for s in splits])
                rows.append({"kernel": "K6 shard", "model": name, "layout": quant, "shard": m,
                             "route": "hits" if m == 0 else route, "span_ms": ms})
                print(f"[parent_turns] K6 {name} {quant} shard {m} "
                      f"({'hits' if m == 0 else route}): span {ms * 1e3:.2f} us", flush=True)
            del table, hot
            torch.cuda.empty_cache()
    return rows


def child(route: str, out: Path) -> int:
    device = torch.device("cuda")
    with torch.inference_mode():
        rows = k5_rows(device) + k6_rows(device, route)
    out.write_text(json.dumps(rows, indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", type=Path, help="the other checkout (its root)")
    p.add_argument("--other_route", default="mask", choices=("mask", "cold"))
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--route", default="cold", choices=("mask", "cold"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("parent_turns: no CUDA card is available", file=sys.stderr)
        return 1
    if args.child is not None:
        return child(args.route, args.child)
    this = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    runs = []
    for n, (root, route) in enumerate(((other, args.other_route), (this, "cold"),
                                       (this, "cold"), (other, args.other_route))):
        out = this / "build" / "parent_turns" / f"run{n}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(root))
        subprocess.run([sys.executable, __file__, "--child", str(out), "--route", route],
                       cwd=root, env=env, check=True)
        runs.append({"checkout": "other" if root == other else "this",
                     "rows": json.loads(out.read_text())})
    res = {"runs": runs}
    for k, row in enumerate(runs[1]["rows"]):
        key = {n: v for n, v in row.items() if n not in ("span_ms", "route")}
        sp = [run["rows"][k]["span_ms"] * 1e3 for run in runs]
        print(f"[parent_turns] {key}: other {sp[0]:.2f}, {sp[3]:.2f} us; this {sp[1]:.2f}, "
              f"{sp[2]:.2f} us", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
