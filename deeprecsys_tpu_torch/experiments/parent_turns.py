"""This checkout's window kernels timed in turns with another checkout's
(an earlier commit, unpacked with ``git archive``), on one card.

    python -m deeprecsys_tpu_torch.experiments.parent_turns --other DIR [--json PATH]
        [--kernels k5,k6,k1bw,k4w,k1b,k1iw,k6s0,fwd] [--turns N]

Runs this file as a child four times (``--turns`` N: 4 N times), in the
order other, this, this, other, each with ``PYTHONPATH`` set to its
checkout, so that each child imports and builds that checkout's package and
nothing else. A child
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
  of 512 and the calls take four later batches;
- ``k6s0``: K6 on shard 0 of that mesh (the hits) at rm1 and rm2 in the
  three layouts, over eight later batches, and the wrapper's host time a
  call there (``host_ms``), beside the host time of the mesh split a batch
  (``split_hot_cold_sharded``, the median of its calls);
  the paths left as they were at rm1: shard 1 on the cold-only route and
  the single-device K6 (``embedding_bag_hotcold*`` on ``split_hot_cold``'s
  split);
- ``fwd``: rm1's 1x4 hot/cold forward (bf16, full size,
  ``make_hotcold_model(mesh=)``, four zipf batches in turn): the wall of a
  whole call (the host split, then the mesh lookup and the towers, waited
  for), of the split alone (``prepare``) and of the rest alone on a split
  made beforehand, each the median of 40 calls after 5;
- K1b's window (``k1bw``: ``embedding_bag_backward_shard`` into a kept f32
  gradient, f32 gradients, the trainer's batch 128), K4's window (``k4w``:
  ``embedding_bag_int8_rowwise_shard``, batch 512) and K1-int8's
  (``k1iw``: ``embedding_bag_int8_shard``, batch 512) at
  ``WINDOW_PLACES``: rm1's and rm2's 1/4 shard 1, rm1's window shifted by
  half a table (three tables meet it, two of them straddling) and dien's
  1/4 shard 1 (its edges mid-table), eight batches of the generator's ids
  each; and the direct K1b (``k1b``) over rm1's whole table. Each checkout
  calls the wrappers with the arguments every checkout since the mesh port
  takes (a newer one derives its table range itself).

Each call is held first to ``embedding_bag_hotcold_reference(...,
partial=True)`` with the mask it stands for (int8 bit for bit, else within
``hotcold_tolerance``), K5's to its plain version
(``sparse_adagrad_tolerance``), K1b's and K4's to theirs
(``backward_tolerance``, ``rowwise_tolerance``, with the window; K1-int8's
int32 pool bit for bit). It uses
only functions that every checkout since the mesh port has. It needs a
CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

K5_CELLS = (("rm1", 4), ("rm1", 2), ("rm2", 4))
K6_MODELS = ("rm1", "rm2")
K6_LAYOUTS = ("none", "int8", "int8_rowwise")
SHARDS = 4
BATCH = 512
TRAIN_BATCH = 128
KERNELS = ("k5", "k6", "k1bw", "k4w", "k1b", "k1iw", "k6s0", "fwd")
# (model, place): shard 1 of 4, or the same window shifted by half of the
# first table.
WINDOW_PLACES = (("rm1", "1/4"), ("rm2", "1/4"), ("rm1", "1/4 + half a table"), ("dien", "1/4"))


def host_ms(fn, args_list, iters: int = 200) -> float:
    """Host time a call: ``iters`` calls back to back by the host clock,
    then a wait for the card (whose share is small where a call's kernels
    take less than its host work), over ``iters``."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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


def shard_split(sp: dict, m: int, device, all_hot: bool = True) -> dict:
    """Shard m's K6 call of ``split_hot_cold_sharded``'s ``sp`` on the
    card: its cold stream and the hits (an all-false mask unless
    ``all_hot``)."""
    on = {k: torch.from_numpy(np.ascontiguousarray(sp[k])).to(device)
          for k in ("hot_sel", "hot_mask", "cold_local", "cold_seg")}
    return {"hot_sel": on["hot_sel"], "cold_ids": on["cold_local"][m].contiguous(),
            "cold_seg": on["cold_seg"][m].contiguous(),
            "hot_mask": on["hot_mask"] if all_hot else torch.zeros_like(on["hot_mask"])}


def _k6_table(quant: str, R: int, d: int, device, seed: int = 1) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    if quant == "none":
        return torch.empty((R, d), dtype=torch.bfloat16, device=device).uniform_(
            -0.05, 0.05, generator=g)
    table = torch.randint(-127, 128, (R, d + (4 if quant == "int8_rowwise" else 0)),
                          generator=g, device=device, dtype=torch.int8)
    if quant == "int8_rowwise":
        sc = torch.rand((R,), generator=g, device=device) * 1e-2 + 1e-4
        table[:, d:] = sc.view(torch.int8).reshape(R, 4)
    return table


def _k6_check(quant: str, got, want, hot, table, split, what: str):
    from deeprecsys_tpu_torch.ops import embedding as emb

    ok = (torch.equal(got, want) if quant == "int8" else bool(
        ((got.float() - want.float()).abs() <= emb.hotcold_tolerance(
            got, want, hot, table, split, rowwise=quant == "int8_rowwise")).all()))
    if not ok:
        raise AssertionError(f"K6 disagrees with its plain version ({what})")


def _k6_plain(quant: str, hot, table, split, partial: bool):
    from deeprecsys_tpu_torch.ops import embedding as emb

    if quant == "none":
        return emb.embedding_bag_hotcold_reference(hot, table, split, partial=partial,
                                                   compute_dtype=torch.bfloat16)
    if quant == "int8":
        scale = None if partial else torch.full((split["hot_sel"].shape[1],), 1e-3,
                                                device=table.device)
        return emb.embedding_bag_hotcold_int8_reference(hot, table, scale, split,
                                                        partial=partial,
                                                        compute_dtype=torch.bfloat16)
    return emb.embedding_bag_hotcold_int8_rowwise_reference(hot, table, split, partial=partial,
                                                            compute_dtype=torch.bfloat16)


def k6s0_rows(device) -> list:
    import types

    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.experiments.skew_bench import _hot_set, zipf_stream
    from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
    from deeprecsys_tpu_torch.ops import embedding as emb
    from deeprecsys_tpu_torch.ops.hotcold import split_hot_cold, split_hot_cold_sharded

    rows = []
    for name in K6_MODELS:
        cfg = zoo.get_config(name, param_dtype="bfloat16", compute_dtype="bfloat16")
        R, d = cfg.total_rows, cfg.sparse_feature_size
        rps = R // SHARDS
        hot_ids, _ = _hot_set(cfg, zipf_stream(cfg, BATCH, seed=22))
        offs = np.asarray(cfg.table_offsets, dtype=np.int64)
        mesh = types.SimpleNamespace(shape={"data": 1, "model": SHARDS})
        streams = [zipf_stream(cfg, BATCH, seed=23 + i) for i in range(8)]
        split_times, splits, singles = [], [], []
        for idx in streams:
            kw = {"cold_buckets": cold_buckets_for(idx.size, mesh), "impl": "native"}
            split_hot_cold_sharded(idx, offs, hot_ids, SHARDS, rps, **kw)  # warm
            for _ in range(5):
                t0 = time.perf_counter()
                sp = split_hot_cold_sharded(idx, offs, hot_ids, SHARDS, rps, **kw)
                split_times.append((time.perf_counter() - t0) * 1e3)
            splits.append([shard_split(sp, m, device) for m in (0, 1)])
            if name == "rm1":
                single = split_hot_cold(idx, offs, hot_ids, cold_buckets=cold_buckets_for(idx.size))
                singles.append({k: torch.from_numpy(np.ascontiguousarray(single[k])).to(device)
                                for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")})
        split_ms = float(np.median(split_times))
        rows.append({"kernel": "mesh split", "model": name, "host_ms": split_ms})
        print(f"[parent_turns] split_hot_cold_sharded {name} 1x{SHARDS}: host "
              f"{split_ms * 1e3:.1f} us a batch (median of {len(split_times)})", flush=True)
        for quant in K6_LAYOUTS:
            table = _k6_table(quant, R, d, device)
            hot = table.index_select(0, torch.as_tensor(hot_ids, device=device))
            wrap = {"none": emb.embedding_bag_hotcold_shard,
                    "int8": emb.embedding_bag_hotcold_int8_shard,
                    "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[quant]
            kw = {"compute_dtype": torch.bfloat16} if quant == "none" else {}
            calls = {"shard 0 (hits)": (lambda s, t=table[:rps]: wrap(hot, t, s[0], **kw),
                                        table[:rps], 0)}
            if name == "rm1":
                B, T, _ = splits[0][1]["hot_sel"].shape
                calls["shard 1 (cold-only)"] = (
                    lambda s, t=table[rps:2 * rps], B=B, T=T: wrap(
                        None, t, {"cold_ids": s[1]["cold_ids"], "cold_seg": s[1]["cold_seg"],
                                  "bags": (B, T)}, **kw), table[rps:2 * rps], 1)
            for label, (call, shard, m) in calls.items():
                s0 = splits[0]
                got = call(s0)
                if m == 0:
                    _k6_check(quant, got, _k6_plain(quant, hot, shard, s0[0], True), hot, shard,
                              s0[0], f"{name} {quant} {label}")
                ms = span_ms(call, [(s,) for s in splits])
                rows.append({"kernel": "K6", "model": name, "layout": quant, "call": label,
                             "span_ms": ms})
                print(f"[parent_turns] K6 {name} {quant} {label}: span {ms * 1e3:.2f} us",
                      flush=True)
                if m == 0:
                    ms = host_ms(call, [(s,) for s in splits])
                    rows.append({"kernel": "K6 host a call", "model": name, "layout": quant,
                                 "call": label, "host_ms": ms})
                    print(f"[parent_turns] K6 {name} {quant} {label}: host {ms * 1e3:.2f} us a "
                          f"call", flush=True)
            if name == "rm1":
                scale = torch.full((cfg.num_tables,), 1e-3, device=device)
                single = {"none": lambda s: emb.embedding_bag_hotcold(
                              hot, table, s, compute_dtype=torch.bfloat16),
                          "int8": lambda s: emb.embedding_bag_hotcold_int8(
                              hot, table, scale, s, compute_dtype=torch.bfloat16),
                          "int8_rowwise": lambda s: emb.embedding_bag_hotcold_int8_rowwise(
                              hot, table, s, compute_dtype=torch.bfloat16)}[quant]
                _k6_check(quant, single(singles[0]), _k6_plain(quant, hot, table, singles[0],
                                                               False),
                          hot, table, singles[0], f"rm1 {quant} single device")
                ms = span_ms(single, [(s,) for s in singles])
                rows.append({"kernel": "K6", "model": name, "layout": quant,
                             "call": "single device", "span_ms": ms})
                print(f"[parent_turns] K6 {name} {quant} single device: span {ms * 1e3:.2f} us",
                      flush=True)
            del table, hot
            torch.cuda.empty_cache()
        del splits, singles
    return rows


def fwd_rows(device) -> list:
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.experiments.skew_bench import _hot_set, zipf_stream
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.models.base import Batch
    from deeprecsys_tpu_torch.models.hotcold import make_hotcold_model
    from deeprecsys_tpu_torch.parallel import make_mesh, shard_params

    cfg = zoo.get_config("rm1", param_dtype="bfloat16", compute_dtype="bfloat16")
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    hot_ids, _ = _hot_set(cfg, zipf_stream(cfg, BATCH, seed=31))
    mesh4 = make_mesh(1, SHARDS, devices=[device] * SHARDS)
    hc = make_hotcold_model(model, hot_ids, mesh=mesh4)
    hp = shard_params(hc.convert_params(params), mesh4)
    dense = np.random.default_rng(31).random((BATCH, cfg.dense_dim), dtype=np.float32)
    hosts = [Batch(dense=dense, indices=zipf_stream(cfg, BATCH, seed=32 + i)) for i in range(4)]
    splits = [hc.prepare(h) for h in hosts]
    tail = Batch(dense=torch.from_numpy(dense).to(device), indices=None)

    def median_ms(fn) -> float:
        walls = []
        for i in range(45):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i % len(hosts))
            torch.cuda.synchronize()
            if i >= 5:
                walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    rows = []
    for part, fn in (("whole call", lambda i: hc.apply(hp, tail, hc.prepare(hosts[i]))),
                     ("split alone", lambda i: hc.prepare(hosts[i])),
                     ("lookup and towers alone", lambda i: hc.apply(hp, tail, splits[i]))):
        wall = median_ms(fn)
        rows.append({"kernel": "1x4 hot/cold forward", "model": "rm1", "part": part,
                     "wall_ms": wall})
        print(f"[parent_turns] rm1 1x{SHARDS} hot/cold forward (bf16, B {BATCH}), {part}: wall "
              f"{wall * 1e3:.1f} us (median of 40)", flush=True)
    del params, hp
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
            splits.append([shard_split(sp, m, device, all_hot=m == 0) for m in (0, 1)])
        for quant in K6_LAYOUTS:
            table = _k6_table(quant, R, d, device)
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
                _k6_check(quant, call(s0), _k6_plain(quant, hot, shard, s0, True), hot, shard, s0,
                          f"{name} {quant} shard {m}")
                ms = span_ms(call, [(s[m],) for s in splits])
                rows.append({"kernel": "K6 shard", "model": name, "layout": quant, "shard": m,
                             "route": "hits" if m == 0 else route, "span_ms": ms})
                print(f"[parent_turns] K6 {name} {quant} shard {m} "
                      f"({'hits' if m == 0 else route}): span {ms * 1e3:.2f} us", flush=True)
            del table, hot
            torch.cuda.empty_cache()
    return rows


def window_of(cfg, place: str) -> tuple:
    """``(row_lo, rows)`` of a ``WINDOW_PLACES`` place of ``cfg``'s fused
    table: shard 1 of 4, shifted by half of the first table for "... +
    half a table"."""
    rps = cfg.total_rows // SHARDS
    return rps + (cfg.scaled_rows[0] // 2 if place.endswith("half a table") else 0), rps


def window_inputs(name: str, place: str, B: int, device, n_batches: int = 8,
                  seed: int = 13, table_scale: int = 1) -> dict:
    """``name``'s config (full size by default), the place's window, the
    fused offsets on ``device`` and ``n_batches`` batches of B of the
    generator's ids."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models.base import table_offsets

    cfg = zoo.get_config(name, table_scale=table_scale)
    lo, rows = window_of(cfg, place)
    return {"cfg": cfg, "row_lo": lo, "rows": rows, "offsets": table_offsets(cfg, device),
            "ids": [b.to(device).indices for b in
                    RecDataGenerator(cfg, seed=seed).generate_batches(n_batches, B)]}


def k1bw_call(inp: dict, device, seed: int = 15):
    """K1b's window at ``inp``'s window: ``(fn(g, ids), args, plain(g, ids),
    grad)`` with f32 gradients of the trainer's batch, adding into one kept
    f32 gradient ``grad``; checked against its plain version first."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    cfg, lo, rows, offsets, ids = (inp[k] for k in ("cfg", "row_lo", "rows", "offsets", "ids"))
    gen = torch.Generator(device=device).manual_seed(seed)
    gs = [torch.randn((ids[0].shape[0], cfg.num_tables, cfg.sparse_feature_size),
                      generator=gen, device=device) * 1e-2 for _ in ids]
    grad = torch.zeros((rows, cfg.sparse_feature_size), dtype=torch.float32, device=device)
    w = (lo, lo + rows)
    got = emb.embedding_bag_backward_shard(gs[0], offsets, ids[0], lo, rows)
    want = emb.embedding_bag_backward_reference(gs[0], offsets, ids[0], rows, window=w)
    if not bool(((got - want).abs()
                 <= emb.backward_tolerance(gs[0], offsets, ids[0], rows, window=w)).all()):
        raise AssertionError(f"K1b's window disagrees with its plain version ({w})")
    del got, want
    return (lambda g, i: emb.embedding_bag_backward_shard(g, offsets, i, lo, rows, out=grad),
            list(zip(gs, ids)),
            lambda g, i: emb.embedding_bag_backward_reference(g, offsets, i, rows, out=grad,
                                                              window=w), grad)


def k4w_call(inp: dict, device, seed: int = 17):
    """K4's window at ``inp``'s window: ``(fn(ids), args, plain(ids),
    shard)`` over a random row-wise int8 shard (positive row scales);
    checked against its plain version first."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    cfg, lo, rows, offsets, ids = (inp[k] for k in ("cfg", "row_lo", "rows", "offsets", "ids"))
    d = cfg.sparse_feature_size
    gen = torch.Generator(device=device).manual_seed(seed)
    shard = torch.randint(-127, 128, (rows, d + 4), generator=gen, device=device,
                          dtype=torch.int8)
    sc = torch.rand((rows,), generator=gen, device=device) * 1e-2 + 1e-4
    shard[:, d:] = sc.view(torch.int8).reshape(rows, 4)
    w = (lo, lo + rows)
    got = emb.embedding_bag_int8_rowwise_shard(shard, offsets, ids[0], lo)
    want = emb.embedding_bag_int8_rowwise_reference(shard, offsets, ids[0], window=w)
    if not bool(((got - want).abs()
                 <= emb.rowwise_tolerance(got, want, shard, offsets, ids[0], window=w)).all()):
        raise AssertionError(f"K4's window disagrees with its plain version ({w})")
    return (lambda i: emb.embedding_bag_int8_rowwise_shard(shard, offsets, i, lo),
            [(i,) for i in ids],
            lambda i: emb.embedding_bag_int8_rowwise_reference(shard, offsets, i, window=w),
            shard)


def k1iw_call(inp: dict, device, seed: int = 19):
    """K1-int8's window at ``inp``'s window: ``(fn(ids), args, plain(ids),
    shard)`` over a random per-table int8 shard; checked against its plain
    version (the exact int32 pool) first."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    cfg, lo, rows, offsets, ids = (inp[k] for k in ("cfg", "row_lo", "rows", "offsets", "ids"))
    gen = torch.Generator(device=device).manual_seed(seed)
    shard = torch.randint(-127, 128, (rows, cfg.sparse_feature_size), generator=gen,
                          device=device, dtype=torch.int8)
    w = (lo, lo + rows)
    if not torch.equal(emb.embedding_bag_int8_shard(shard, offsets, ids[0], lo),
                       emb.embedding_bag_int8_reference(shard, None, offsets, ids[0], window=w)):
        raise AssertionError(f"K1-int8's window differs from its plain version ({w})")
    return (lambda i: emb.embedding_bag_int8_shard(shard, offsets, i, lo), [(i,) for i in ids],
            lambda i: emb.embedding_bag_int8_reference(shard, None, offsets, i, window=w), shard)


WINDOW_CALLS = {"k1bw": (k1bw_call, "K1b window"), "k4w": (k4w_call, "K4 window"),
                "k1iw": (k1iw_call, "K1-int8 window")}


def window_rows(device, kernel: str) -> list:
    rows = []
    for name, place in WINDOW_PLACES:
        inp = window_inputs(name, place, TRAIN_BATCH if kernel == "k1bw" else BATCH, device)
        make, label = WINDOW_CALLS[kernel]
        fn, args, _, kept = make(inp, device)
        ms = span_ms(fn, args)
        rows.append({"kernel": label, "model": name, "place": place,
                     "window": [inp["row_lo"], inp["row_lo"] + inp["rows"]], "span_ms": ms})
        print(f"[parent_turns] {label} {name} {place} rows [{inp['row_lo']}, "
              f"{inp['row_lo'] + inp['rows']}): span {ms * 1e3:.2f} us", flush=True)
        del inp, kept, fn, args
        torch.cuda.empty_cache()
    return rows


def k1b_rows(device) -> list:
    """The direct K1b over rm1's whole f32 table (out= a kept gradient)."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    inp = window_inputs("rm1", "1/4", TRAIN_BATCH, device)
    cfg, offsets, ids = inp["cfg"], inp["offsets"], inp["ids"]
    R, d = cfg.total_rows, cfg.sparse_feature_size
    gen = torch.Generator(device=device).manual_seed(15)
    gs = [torch.randn((TRAIN_BATCH, cfg.num_tables, d), generator=gen, device=device) * 1e-2
          for _ in ids]
    got = emb.embedding_bag_backward(gs[0], offsets, ids[0], R)
    want = emb.embedding_bag_backward_reference(gs[0], offsets, ids[0], R)
    if not bool(((got - want).abs()
                 <= emb.backward_tolerance(gs[0], offsets, ids[0], R)).all()):
        raise AssertionError("K1b disagrees with its plain version")
    del got, want
    grad = torch.zeros((R, d), dtype=torch.float32, device=device)
    ms = span_ms(lambda g, i: emb.embedding_bag_backward(g, offsets, i, R, out=grad),
                 list(zip(gs, ids)))
    print(f"[parent_turns] K1b direct rm1 whole table: span {ms * 1e3:.2f} us", flush=True)
    del grad
    torch.cuda.empty_cache()
    return [{"kernel": "K1b direct", "model": "rm1", "place": "whole table", "span_ms": ms}]


def child(route: str, out: Path, kernels: list) -> int:
    device = torch.device("cuda")
    rows = []
    with torch.inference_mode():
        for k in kernels:
            rows += {"k5": lambda: k5_rows(device), "k6": lambda: k6_rows(device, route),
                     "k1bw": lambda: window_rows(device, "k1bw"),
                     "k4w": lambda: window_rows(device, "k4w"),
                     "k1iw": lambda: window_rows(device, "k1iw"),
                     "k1b": lambda: k1b_rows(device), "k6s0": lambda: k6s0_rows(device),
                     "fwd": lambda: fwd_rows(device)}[k]()
    out.write_text(json.dumps(rows, indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", type=Path, help="the other checkout (its root)")
    p.add_argument("--other_route", default="mask", choices=("mask", "cold"))
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help=f"comma-separated, of {','.join(KERNELS)} (default: all)")
    p.add_argument("--turns", type=int, default=1,
                   help="repeat the other, this, this, other order this many times")
    p.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--route", default="cold", choices=("mask", "cold"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("parent_turns: no CUDA card is available", file=sys.stderr)
        return 1
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        p.error(f"--kernels takes {','.join(KERNELS)}; got {args.kernels}")
    if args.child is not None:
        return child(args.route, args.child, kernels)
    this = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    runs = []
    order = ((other, args.other_route), (this, "cold"), (this, "cold"),
             (other, args.other_route)) * args.turns
    for n, (root, route) in enumerate(order):
        out = this / "build" / "parent_turns" / f"run{n}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(root))
        subprocess.run([sys.executable, __file__, "--child", str(out), "--route", route,
                        "--kernels", args.kernels], cwd=root, env=env, check=True)
        runs.append({"checkout": "other" if root == other else "this",
                     "rows": json.loads(out.read_text())})
    res = {"runs": runs}
    for k, row in enumerate(runs[1]["rows"]):
        metric = next(n for n in ("span_ms", "host_ms", "wall_ms") if n in row)
        key = {n: v for n, v in row.items() if n not in (metric, "route")}
        by = {c: ", ".join(f"{run['rows'][k][metric] * 1e3:.2f}" for run in runs
                           if run["checkout"] == c) for c in ("other", "this")}
        print(f"[parent_turns] {key} ({metric[:-3]}): other {by['other']} us; this "
              f"{by['this']} us", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
