"""Mapping sweep of the hot/cold lookup K6 on one card.

    python -m deeprecsys_tpu_torch.experiments.k6_sweep [--json PATH] [--models rm1,rm2,din]
        [--layouts none,int8_rowwise,int8]
    python -m deeprecsys_tpu_torch.experiments.k6_sweep --pdl_only [--json PATH]

``ops/csrc/embedding_bag_hotcold.cu`` is built with only the mapping a
layout ships (``Shipped`` there, ``ops.embedding.k6_geometry`` here) and the
plans ``k6_launch_plan`` picks. This script chose the mappings: it writes
translation units into ``build/k6_sweep/`` that include that source and add
one C entry point over a wider set of instances of the pooling launch
(values a lane; on long bags bags a warp, rows a slot a step and the most
ids a lane a window; on short bags rows a step; the load hint), builds them
(``experiments.sweep_build``), holds every instance to its plain version
(``hotcold_tolerance``; per-table int8 bit for bit) and times it at each
model's shape (default rm1, rm2 and din): bf16 output, batch 512,
full-size tables, 8 batches of zipf(1.2) ids with the JAX hot-set rule
(``kernel_bench.hotcold_inputs``). Each time is K6's, both launches (the
``cold_start`` build, then the instance), beside the shipped wrapper's and
the direct kernel's on the same ids, with the instance's registers and
spills (ptxas). Then it times the shipped mapping of each layout swept,
through the same entry point, with and without programmatic dependent
launch of the pool, in turns (on, off, off, on); ``--pdl_only`` builds
only the shipped mappings and runs only these turns. Last it times the
``cold_start`` launch with nothing to do, a launch's floor on the card.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from deeprecsys_tpu_torch.experiments.sweep_build import build_units, ptxas_of

MODES = {"none": (0, "__nv_bfloat16"), "int8": (1, "int8_t"), "int8_rowwise": (2, "int8_t")}
MODEL_LAYOUT = {"none": "float", "int8": "int8", "int8_rowwise": "int8_rowwise"}
MODELS = ("rm1", "rm2", "din")
LAYOUTS = ("none", "int8_rowwise", "int8")
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def instances(layout: str, d: int, short: bool) -> list:
    """``(values a lane, bags a warp, rows a slot a step, hint, most ids a
    lane a window)`` of the sweep. Float (bf16) lanes load 16 bytes (8
    values); row-wise lanes 8 or 16 values: a warp a bag (long bags) takes
    1-8 rows a slot a step, up to 64 slots a step; a slot a bag (short
    bags) loads all of its rows at once. Per-table int8 lanes load 16
    bytes: long bags 1, 2 or 4 bags a warp, 2-4 rows a slot a step, windows
    of at most 1, 2 or 4 ids a lane (its front end pipelined across
    windows), no hint or on cold rows (the hint on every row lost at every
    long-bag shape, PERF.md); short bags 1, 2 or all of their rows a
    step. The hint (``load_row16``): none, on every row, on cold rows
    only."""
    hints = (0, 1, 2)
    if layout == "int8":
        if short:
            return [(16, 1, u, h, 4) for u in (1, 2, 8) for h in hints]
        return [(16, g, u, h, cap) for g in (1, 2, 4) for u in (2, 3, 4) for h in (0, 2)
                for cap in (1, 2, 4)]
    values = (8,) if layout == "none" else (8, 16)
    out = []
    for v in values:
        slots = 32 // (d // v)
        rows = (8,) if short else tuple(u for u in (1, 2, 4, 8) if 8 <= slots * u <= 64)
        out += [(v, 1, u, h, 4) for u in rows for h in hints]
    return out


def _plan(n_bags: int, L: int, d: int, inst) -> tuple:
    """(rows_per_slot, ids_per_lane, grid, rows a step) of ``inst``
    (k6_launch_plan's rule)."""
    from deeprecsys_tpu_torch.ops.embedding import (
        K6_WARPS_PER_BLOCK, K6Geometry, _pow2_at_least, k6_window_ids)

    v, g, u, _, cap = inst
    slots = 32 // (d // v)
    if L <= 8:
        ub, ni, bpw, step = _pow2_at_least(max(L, 1)), 1, slots, min(u, _pow2_at_least(max(L, 1)))
    else:
        geo = K6Geometry(v, d // v, slots, u, 0, g, cap)
        ub, bpw, step = 0, g, u
        ni = k6_window_ids(L, geo)
    tasks = -(-n_bags // bpw)
    return ub, ni, max(1, -(-tasks // K6_WARPS_PER_BLOCK)), step


def _key(layout: str, d: int, L: int, inst) -> tuple:
    n_bags = 1  # the plan's shape does not depend on n_bags
    ub, ni, _, step = _plan(n_bags, L, d, inst)
    v, g, _, h, _ = inst
    if ub == 1:
        h = 0  # one row: no hint, as k6_launch_plan
    return (layout, d, ub, ni, v, g if ub == 0 else 1, step, int(h))


def _source(src: Path, keys: list) -> str:
    cases = []
    for n, (layout, d, ub, ni, v, g, u, h) in enumerate(keys):
        mode, tin = MODES[layout]
        mname = {0: "kFloat", 1: "kInt8", 2: "kRowwise"}[mode]
        cases.append(f"    case {n}: return launch<{mname}, {tin}, __nv_bfloat16, {d}, {v}, {g}, "
                     f"{u}, {h}, {ub}, {ni}>(a, pdl != 0);")
    body = "\n".join(cases)
    return f"""#include "{src}"
extern "C" int drs_k6_sweep(int key, const void* hot, const void* table, const void* scale,
                            const void* hot_sel, const void* hot_mask, const void* cold_ids,
                            const void* cold_seg, int64_t c_pad, void* cold_start, void* out,
                            int64_t n_bags, int T, int L, int grid, int pdl, void* stream) {{
  const Args a = make_args(hot, table, scale, hot_sel, hot_mask, cold_ids, cold_seg, c_pad,
                           cold_start, out, n_bags, T, L, grid, stream);
  const int err = launch_cold_starts(a);
  if (err != 0) return err;
  switch (key) {{
{body}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""


def sweep_keys(models, layouts=LAYOUTS) -> list:
    from deeprecsys_tpu_torch import zoo

    keys = []
    for name in models:
        cfg = zoo.get_config(name)
        d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
        for layout in layouts:
            keys += [_key(layout, d, L, inst) for inst in instances(layout, d, L <= 8)]
    return list(dict.fromkeys(keys))


def _shipped_inst(layout: str, L: int, d: int, n_bags: int) -> tuple:
    from deeprecsys_tpu_torch.ops.embedding import k6_launch_plan

    geo = k6_launch_plan(n_bags, L, MODEL_LAYOUT[layout], d,
                         2 if layout == "none" else 1).geometry
    return (geo.values_per_lane, geo.bags_per_warp, geo.rows_per_slot, geo.hint,
            geo.ids_per_lane)


def shipped_keys(models, layouts=LAYOUTS) -> list:
    """The sweep key of the mapping and plan that ``k6_launch_plan`` ships
    for each layout of ``layouts`` at each model's shape (batch 512)."""
    from deeprecsys_tpu_torch import zoo

    keys = []
    for name in models:
        cfg = zoo.get_config(name)
        d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
        for layout in layouts:
            keys.append(_key(layout, d, L, _shipped_inst(layout, L, d, 512 * cfg.num_tables)))
    return list(dict.fromkeys(keys))


def build_all(keys: list, log) -> tuple:
    """The instances, up to eight translation units compiled in parallel:
    ((CDLL, case) of each key, ptxas lines)."""
    from deeprecsys_tpu_torch.ops import _build

    src = _build.CSRC / "embedding_bag_hotcold.cu"
    groups = [g for g in (keys[i::8] for i in range(8)) if g]
    built = build_units("k6_sweep", {f"k6_sweep_{n}": _source(src, g)
                                     for n, g in enumerate(groups)}, "drs_k6_sweep", ARGTYPES)
    libs, lines = {}, []
    for group, (lib, ptx) in zip(groups, built.values()):
        for i, key in enumerate(group):
            libs[key] = (lib, i)
        lines += ptx
    log(f"{len(keys)} instances; ptxas " + "; ".join(lines))
    return libs, lines


def _call(lib_i, key, hot, table, split: dict, d: int, pdl: bool = True, scale=None):
    """Both launches of ``key``'s instance (``scale``: per-table int8's)."""
    from deeprecsys_tpu_torch.ops.embedding import K6_WARPS_PER_BLOCK

    lib, i = lib_i
    B, T, L = split["hot_sel"].shape
    out = torch.empty((B, T, d), dtype=torch.bfloat16, device=table.device)
    starts = torch.empty((B * T + 1,), dtype=torch.int32, device=table.device)
    _, _, ub, _, v, g, _, _ = key
    tasks = -(-B * T // (g if ub == 0 else 32 // (d // v)))
    grid = max(1, -(-tasks // K6_WARPS_PER_BLOCK))
    err = lib.drs_k6_sweep(i, hot.data_ptr() or None, table.data_ptr(),
                           None if scale is None else scale.data_ptr(),
                           split["hot_sel"].data_ptr(), split["hot_mask"].data_ptr(),
                           split["cold_ids"].data_ptr() or None,
                           split["cold_seg"].data_ptr() or None, split["cold_ids"].numel(),
                           starts.data_ptr(), out.data_ptr(), B * T, T, L, grid, int(pdl),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep instance {key} failed to launch ({err})")
    return out


def _ptxas_of(lines: list, key) -> str:
    layout, d, ub, ni, v, g, u, h = key
    tin = "bf16" if layout == "none" else "int8"
    mode = MODES[layout][0]
    tag = (f"embedding_bag_hotcold_kernel<{mode}, {tin}, S, {d}, {v}, {g}, {u}, {h}, {ub}, "
           f"{ni}>")
    return ptxas_of(lines, tag, tag.replace(", S,", ", bf16,"))


def _agrees(got, want, inp: dict, split: dict, layout: str) -> bool:
    """Per-table int8 bit for bit; float and row-wise within
    ``hotcold_tolerance``."""
    from deeprecsys_tpu_torch.ops.embedding import hotcold_tolerance

    if layout == "int8":
        return torch.equal(got, want)
    tol = hotcold_tolerance(want, want, inp["hot"], inp["rows"], split,
                            rowwise=layout == "int8_rowwise")
    return bool(((got.float() - want.float()).abs() <= tol).all())


def _scale(inp: dict, layout: str):
    return inp["tables"]["scale"] if layout == "int8" else None


def sweep_model(name: str, libs: dict, lines: list, log, layouts=LAYOUTS) -> list:
    """Every instance of ``layouts`` at ``name``'s shape."""
    from deeprecsys_tpu_torch.kernel_bench import _us, hotcold_calls, hotcold_inputs, measure

    device = torch.device("cuda")
    rows = []
    for layout in layouts:
        inp = hotcold_inputs(name, layout, device)
        cfg = inp["cfg"]
        d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
        calls = hotcold_calls(inp, layout)
        table, sc = inp["rows"], _scale(inp, layout)
        shipped = measure(calls["kernel"], inp["batches"])
        direct = measure(calls["direct"], inp["batches"])
        i0, s0 = inp["batches"][0]
        want = calls["plain"](i0, s0)
        for inst in instances(layout, d, L <= 8):
            key = _key(layout, d, L, inst)
            if any(r["key"] == list(key) for r in rows):
                continue  # short bags: options that launch one instance
            got = _call(libs[key], key, inp["hot"], table, s0, d, scale=sc)
            if not _agrees(got, want, inp, s0, layout):
                raise AssertionError(f"K6 {key} disagrees with its plain version at {name}")
            run = measure(lambda i, s: _call(libs[key], key, inp["hot"], table, s, d, scale=sc),
                          inp["batches"])
            row = {"model": name, "layout": layout, "d": d, "L": L, "key": list(key),
                   "values_per_lane": inst[0], "bags_per_warp": key[5], "rows_per_slot": key[6],
                   "hint": key[7], "ids_per_lane": key[3], "ms": run["launch_sum_ms"],
                   "us_by_kernel": run["us_by_kernel"], "shipped_ms": shipped["launch_sum_ms"],
                   "direct_ms": direct["kernel_ms"], "ptxas": _ptxas_of(lines, key)}
            rows.append(row)
            log(f"{name} {layout} V {inst[0]} G {key[5]} U {key[6]} hint {key[7]} NI {key[3]}: "
                f"{_us(row['ms'])} (shipped {_us(row['shipped_ms'])}, direct kernel "
                f"{_us(row['direct_ms'])}); {row['ptxas']}")
        del inp, calls, table, sc
        torch.cuda.empty_cache()
    return rows


def pdl_turns(name: str, libs: dict, log, layouts=LAYOUTS) -> dict:
    """The shipped mapping of each layout of ``layouts`` at ``name``'s
    shape, launched through the sweep's entry point with and without
    programmatic dependent launch of the pool, in turns on, off, off, on:
    the sum of both launches, the ``cold_start`` launch's median, the span
    (``kernel_bench.span_ms``: overlapping launches count once) and the wall
    time a call, each the mean of its two runs; beside them the
    ``cold_start`` launch alone (``hotcold_cold_starts``) on the same
    batches. Both ways are first held to the plain version."""
    from deeprecsys_tpu_torch.kernel_bench import (
        _us, hotcold_calls, hotcold_inputs, measure, named_kernel_ms, span_ms)
    from deeprecsys_tpu_torch.ops.embedding import hotcold_cold_starts

    device = torch.device("cuda")
    keys = shipped_keys([name], layouts)
    out = {}
    for layout, key in zip(layouts, keys):
        inp = hotcold_inputs(name, layout, device)
        d = inp["cfg"].sparse_feature_size
        sc = _scale(inp, layout)
        i0, s0 = inp["batches"][0]
        want = hotcold_calls(inp, layout)["plain"](i0, s0)
        runs = {}
        for n, pdl in enumerate((True, False, False, True)):
            def call(i, s, pdl=pdl):
                return _call(libs[key], key, inp["hot"], inp["rows"], s, d, pdl, sc)
            if n < 2 and not _agrees(call(i0, s0), want, inp, s0, layout):
                raise AssertionError(f"K6 {key} (pdl {pdl}) disagrees with its plain version")
            run = measure(call, inp["batches"])
            runs[(pdl, n)] = {**run, "starts_ms": named_kernel_ms(run, "cold_starts"),
                              "span_ms": span_ms(call, inp["batches"])}
        res = {}
        for pdl in (True, False):
            rs = [r for (p, _), r in runs.items() if p == pdl]
            res["pdl" if pdl else "no_pdl"] = {
                k: sum(r[k] for r in rs) / len(rs) for k in ("launch_sum_ms", "starts_ms",
                                                             "span_ms", "wall_ms")}
        n_bags = i0.shape[0] * i0.shape[1]
        res["starts_alone_ms"] = measure(lambda i, s: hotcold_cold_starts(s["cold_seg"], n_bags),
                                         inp["batches"])["kernel_ms"]
        out[layout] = res
        log(f"PDL {name} {layout} {key}: " + "; ".join(
            f"{label} sum {_us(r['launch_sum_ms'])} (cold_start {_us(r['starts_ms'])}), span "
            f"{_us(r['span_ms'])}, wall {_us(r['wall_ms'])}"
            for label, r in (("on", res["pdl"]), ("off", res["no_pdl"])))
            + f"; cold_start alone {_us(res['starts_alone_ms'])}")
        del inp
        torch.cuda.empty_cache()
    return out


def launch_floor(log) -> float:
    """The ``cold_start`` launch alone on an empty cold stream and one bag
    (one block, one store): the least time a launch takes as the trace
    sees it on this card."""
    from deeprecsys_tpu_torch.kernel_bench import _us, measure
    from deeprecsys_tpu_torch.ops.embedding import hotcold_cold_starts

    empty = torch.empty(0, dtype=torch.int32, device="cuda")
    ms = measure(lambda: hotcold_cold_starts(empty, 1), [()])["kernel_ms"]
    log(f"cold_start launch on an empty stream, one bag: {_us(ms)}")
    return ms


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--models", type=str, default=",".join(MODELS))
    p.add_argument("--layouts", type=str, default=",".join(LAYOUTS),
                   help="table layouts to sweep: none (bf16), int8_rowwise, int8")
    p.add_argument("--pdl_only", action="store_true",
                   help="build only the shipped mappings and run only their PDL turns")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k6_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    models, layouts = args.models.split(","), args.layouts.split(",")
    with torch.inference_mode():
        res = {"card": card}
        libs, lines = build_all(shipped_keys(models, layouts) if args.pdl_only
                                else sweep_keys(models, layouts), log)
        if not args.pdl_only:
            res["rows"] = [r for name in models
                           for r in sweep_model(name, libs, lines, log, layouts)]
        res["pdl"] = {name: pdl_turns(name, libs, log, layouts) for name in models}
        res["launch_floor_ms"] = launch_floor(log)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
