"""K6 on shard 0 of a hot/cold mesh (the shard that counts the hot hits):
its two launches against the pool alone over a pointer made on the host,
and the pool's mapping there, on one card.

    python -m deeprecsys_tpu_torch.experiments.k6_shard0_sweep [--json PATH]
        [--models rm1,rm2] [--layouts none,int8,int8_rowwise]

``ops/csrc/embedding_bag_hotcold.cu`` pools shard 0's hits and cold stream
in two launches: ``cold_starts_kernel`` builds the CSR pointer of the cold
stream (entry g the cold entries of bags before g), then the pool reads it,
started by programmatic dependent launch. Design (a) takes the first launch
away: the mesh splitter writes the pointer on the host and copies it to the
card beside ``cold_seg``. This script writes translation units into
``build/k6_shard0_sweep/`` that include that source
(``experiments.sweep_build``) and add:

- one C entry point over the pool's instances, each launched alone over a
  pointer it is given (no PDL): the shipped mapping and more (bags a warp
  G, rows a slot a step U, the most ids a lane a window);
- ``drs_k6s0_pointer``, host code: design (a)'s pointer written in one
  pass over shard 0's sorted cold segments, as a native splitter would
  write it.

At shard 0 of the model's 1x4 mesh on zipf(1.2) ids, the hot set fitted on
a warm-up batch of 512 and the calls taking eight later batches
(``kernel_bench.hotcold_shard_inputs``), each instance is held to the plain
version (``embedding_bag_hotcold*_reference(..., partial=True)``: per-table
int8 bit for bit, the others within ``hotcold_tolerance``) and the native
pointer to ``hotcold_cold_starts_reference``. Then, in turns (forward, then
backward), the span (``kernel_bench.span_ms``) of the shipped wrapper (both
launches) and of each instance, and each one's device time
(``measure``); and on the host, a batch: the mesh split
(``split_hot_cold_sharded``), the native pointer, a numpy ``bincount`` and
``cumsum`` pointer, and the pointer's copy to the card as the mesh path
copies the split (``parallel.sharding._to``), each the median of five
calls a batch. Design (a)'s cost a batch is its pointer, its copy and its
span; the shipped path's is its span; the split is the same in both.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from deeprecsys_tpu_torch.experiments.sweep_build import build_units

MODELS = ("rm1", "rm2")
LAYOUTS = ("none", "int8", "int8_rowwise")
# layout: (Mode, table element, accumulator type TC, partial type TO)
TYPES = {"none": ("kFloat", "__nv_bfloat16", "float", "float"),
         "int8": ("kInt8", "int8_t", "float", "int32_t"),
         "int8_rowwise": ("kRowwise", "int8_t", "float", "float")}
ENTRY = "drs_k6s0_sweep"
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p,
                                                      ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
POINTER = "drs_k6s0_pointer"
POINTER_SOURCE = f"""
// Design (a)'s CSR pointer on the host: out[g] = the entries of
// seg[0, c) (sorted by bag, pads of n_bags or more last) below bag g, for
// g in [0, n_bags], in one pass.
extern "C" void {POINTER}(const int32_t* seg, int64_t c, int64_t n_bags, int32_t* out) {{
  int64_t g = 0, i = 0;
  for (; i < c && seg[i] < n_bags; ++i)
    while (g <= seg[i]) out[g++] = (int32_t)i;
  while (g <= n_bags) out[g++] = (int32_t)i;
}}
"""


def instances(layout: str, d: int) -> list:
    """``(values a lane, bags a warp, rows a slot a step, hint, most ids a
    lane a window)`` of the sweep for long bags, each layout at its lanes'
    width and hint: float (bf16) rows 1 or 2 bags a warp and 1-8 rows a
    slot a step; row-wise rows a warp a bag, 1-4 rows; per-table int8 rows
    1, 2 or 4 bags a warp, 2 or 4 rows, windows of 1 or 2 ids a lane."""
    from deeprecsys_tpu_torch.ops.embedding import k6_geometry

    geo = k6_geometry({"none": "float"}.get(layout, layout), d, 2 if layout == "none" else 1)
    v, h = geo.values_per_lane, geo.hint
    if layout == "none":
        return [(v, g, u, h, 4) for g in (1, 2) for u in (1, 2, 4, 8)]
    if layout == "int8_rowwise":
        return [(v, 1, u, h, 4) for u in (1, 2, 4)]
    return [(v, g, u, h, cap) for g in (1, 2, 4) for u in (2, 4) for cap in (1, 2)]


def shipped(layout: str, d: int) -> tuple:
    """The shipped long-bag mapping of ``layout`` at width ``d``
    (``k6_geometry``), in ``instances``' form."""
    from deeprecsys_tpu_torch.ops.embedding import k6_geometry

    geo = k6_geometry({"none": "float"}.get(layout, layout), d, 2 if layout == "none" else 1)
    return (geo.values_per_lane, geo.bags_per_warp, geo.rows_per_slot, geo.hint,
            geo.ids_per_lane)


def key_of(layout: str, d: int, L: int, inst) -> tuple:
    """``(layout, d, ids a lane, V, G, U, hint)``: the instance's template
    arguments at bags of L slots (``k6_sweep._plan``'s window rule)."""
    from deeprecsys_tpu_torch.experiments.k6_sweep import _plan

    _, ni, _, _ = _plan(1, L, d, inst)
    v, g, u, h, _ = inst
    return (layout, d, ni, v, g, u, h)


def _source(src: Path, keys: list) -> str:
    text = src.read_text().replace('#include "pooled_rows.cuh"',
                                   (src.parent / "pooled_rows.cuh").read_text())
    cases = []
    for n, (layout, d, ni, v, g, u, h) in enumerate(keys):
        mode, tin, tc, to = TYPES[layout]
        cases.append(f"    case {n}: return launch<{mode}, {tin}, {tc}, {d}, {v}, {g}, {u}, {h}, "
                     f"0, {ni}, {to}>(a, false);")
    body = "\n".join(cases)
    return f"""{text}
extern "C" int {ENTRY}(int key, const void* hot, const void* table, const void* hot_sel,
                              const void* hot_mask, const void* cold_ids, const void* cold_seg,
                              int64_t c_pad, void* cold_start, void* out, int64_t n_bags, int T,
                              int L, int grid, void* stream) {{
  const Args a = make_args(hot, table, nullptr, hot_sel, hot_mask, cold_ids, cold_seg, c_pad,
                           cold_start, out, n_bags, T, L, grid, stream);
  switch (key) {{
{body}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
{POINTER_SOURCE}"""


def units(csrc: Path, keys: list) -> dict:
    """``{stem: source}``: ``keys`` in up to six units, each with the
    shipped source whole, the entry point over its keys and the host
    pointer."""
    src = csrc / "embedding_bag_hotcold.cu"
    groups = [g for g in (keys[i::6] for i in range(6)) if g]
    return {f"k6s0_{n}": _source(src, g) for n, g in enumerate(groups)}


def host_pointer(lib, seg: np.ndarray, n_bags: int) -> np.ndarray:
    """``drs_k6s0_pointer`` of ``lib`` on a host int32 cold stream."""
    out = np.empty(n_bags + 1, dtype=np.int32)
    getattr(lib, POINTER)(seg.ctypes.data, seg.size, n_bags, out.ctypes.data)
    return out


def numpy_pointer(seg: np.ndarray, n_bags: int) -> np.ndarray:
    """The same pointer from the counts of the segments (pads dropped by
    ``bincount``'s last bin)."""
    out = np.empty(n_bags + 1, dtype=np.int32)
    out[0] = 0
    np.cumsum(np.bincount(seg, minlength=n_bags + 1)[:n_bags], out=out[1:])
    return out


def _call(lib_i, key, hot, shard, split: dict, starts):
    """One instance's launch on shard 0's split over ``starts`` (the cold
    stream's pointer on the card); returns the partial."""
    from deeprecsys_tpu_torch.ops.embedding import K6_WARPS_PER_BLOCK

    lib, i = lib_i
    layout, d, _, _, g = key[:5]
    B, T, L = split["hot_sel"].shape
    out = torch.empty((B, T, d), dtype=torch.int32 if layout == "int8" else torch.float32,
                      device=shard.device)
    tasks = -(-B * T // g)
    err = getattr(lib, ENTRY)(i, hot.data_ptr() or None, shard.data_ptr(),
                              split["hot_sel"].data_ptr(), split["hot_mask"].data_ptr(),
                              split["cold_ids"].data_ptr() or None,
                              split["cold_seg"].data_ptr() or None, split["cold_ids"].numel(),
                              starts.data_ptr(), out.data_ptr(), B * T, T, L,
                              max(1, -(-tasks // K6_WARPS_PER_BLOCK)),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep instance {key} failed to launch ({err})")
    return out


def _ptxas(lines: list, key) -> str:
    """The ptxas line of the pool instance of ``key``'s arguments
    (``kernel_bench.kernel_instance``'s names: the mode as a number) with
    an f32 accumulator."""
    layout, d, ni, v, g, u, h = key
    mode = {"none": 0, "int8": 1, "int8_rowwise": 2}[layout]
    tin = "bf16" if layout == "none" else "int8"
    head = f"embedding_bag_hotcold_kernel<{mode}, {tin}, f32, {d}, {v}, {g}, {u}, {h}, 0, {ni}, "
    return next((x.partition(": ")[2] for x in lines if x.startswith(head)), "not found")


def _host_ms(fn, batches: list) -> float:
    """The median host time of ``fn(batch)``, five calls a batch."""
    times = []
    for b in batches:
        for _ in range(5):
            t0 = time.perf_counter()
            fn(b)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sweep(models, layouts, log) -> list:
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.kernel_bench import (
        _check_shard_partial, _us, hotcold_shard_inputs, k6_shard_calls, measure, span_ms)
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import hotcold_cold_starts_reference
    from deeprecsys_tpu_torch.parallel.sharding import _to

    plan = {}
    for name in models:
        cfg = zoo.get_config(name)
        d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
        for layout in layouts:
            ship = key_of(layout, d, L, shipped(layout, d))
            keys = list(dict.fromkeys([ship] + [key_of(layout, d, L, i)
                                                for i in instances(layout, d)]))
            plan[(name, layout)] = (keys, ship)
    keys = list(dict.fromkeys(k for ks, _ in plan.values() for k in ks))
    built = build_units("k6_shard0_sweep", units(_build.CSRC, keys), ENTRY, ARGTYPES)
    libs, lines = {}, []
    for n, stem in enumerate(built):
        lib = built[stem][0]
        getattr(lib, POINTER).restype = None
        getattr(lib, POINTER).argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_void_p]
        for i, key in enumerate(keys[n::len(built)]):
            libs[key] = (lib, i)
        lines += built[stem][1]
    host_lib = built[next(iter(built))][0]
    log(f"{len(keys)} instances of the pool alone, over a pointer given")
    device = torch.device("cuda")
    rows = []
    for (name, layout), (ks, ship) in plan.items():
        inp = hotcold_shard_inputs(name, layout, device)
        shard, hot = inp["shards"][0], inp["hot"]
        args = [(s[0],) for s in inp["splits"]]
        B, T, _ = args[0][0]["hot_sel"].shape
        segs = [s["cold_seg"].cpu().numpy() for (s,) in args]  # as the splitter holds them
        pointers = [host_pointer(host_lib, seg, B * T) for seg in segs]
        for (s,), ptr in zip(args, pointers):
            want = hotcold_cold_starts_reference(s["cold_seg"], B * T).cpu().numpy()
            if not (np.array_equal(ptr, want) and np.array_equal(numpy_pointer(
                    s["cold_seg"].cpu().numpy(), B * T), want)):
                raise AssertionError(f"{name} {layout}: a host pointer differs from "
                                     f"hotcold_cold_starts_reference")
        starts = {id(s): torch.from_numpy(ptr).to(device) for (s,), ptr in zip(args, pointers)}
        wrapper, plain = k6_shard_calls(layout, hot, shard)["with_hits"]
        fns = {"shipped": wrapper}
        fns.update({k: (lambda s, k=k: _call(libs[k], k, hot, shard, s, starts[id(s)]))
                    for k in ks})
        s0 = args[0][0]
        want = plain(s0)
        for label, fn in fns.items():
            _check_shard_partial(layout, fn(s0), want, shard, hot, s0, f"{name} {layout} {label}")
        spans = {label: [] for label in fns}
        for label in list(fns) + list(fns)[::-1]:
            spans[label].append(span_ms(fns[label], args))
        host = {"split_ms": inp["split_ms"],
                "pointer_ms": _host_ms(lambda seg: host_pointer(host_lib, seg, B * T), segs),
                "numpy_pointer_ms": _host_ms(lambda seg: numpy_pointer(seg, B * T), segs),
                "copy_ms": _host_ms(lambda p: _to(torch.from_numpy(p), device), pointers)}
        torch.cuda.synchronize()
        wrap_span = float(np.mean(spans["shipped"]))
        log(f"{name} {layout} shard 0: the shipped two launches' span {_us(wrap_span)} ("
            + ", ".join(_us(x) for x in spans["shipped"]) + f"); host a batch: the mesh split "
            f"{_us(host['split_ms'])}, design (a)'s native pointer {_us(host['pointer_ms'])}, "
            f"numpy's {_us(host['numpy_pointer_ms'])}, its copy {_us(host['copy_ms'])}")
        for label, fn in fns.items():
            run = measure(fn, args)
            span = float(np.mean(spans[label]))
            row = {"model": name, "layout": layout, "call": "shipped" if label == "shipped"
                   else "pool over a host pointer", "span_ms": span, "spans_ms": spans[label],
                   "device_ms": run["device_ms"], "launches": run["launches"], **host,
                   "shipped_span_ms": wrap_span}
            if label != "shipped":
                row.update(key=list(label), bags_per_warp=label[4], rows_per_slot=label[5],
                           ids_per_lane=label[2], shipped_mapping=label == ship,
                           ptxas=_ptxas(lines, label),
                           design_a_ms=host["pointer_ms"] + host["copy_ms"] + span)
            rows.append(row)
            if label == "shipped":
                log(f"  shipped: device {_us(run['device_ms'])} in {run['launches']:.0f} "
                    f"launches")
                continue
            log(f"  pool alone G {label[4]} U {label[5]} NI {label[2]}"
                + (" [the shipped mapping]" if label == ship else "") + f": span {_us(span)} ("
                + ", ".join(_us(x) for x in spans[label]) + f"), device {_us(run['device_ms'])}; "
                f"design (a) a batch (pointer + copy + span) {_us(row['design_a_ms'])} against "
                f"the shipped span {_us(wrap_span)}; {row['ptxas']}")
        del inp, fns, args, starts
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--models", type=str, default=",".join(MODELS))
    p.add_argument("--layouts", type=str, default=",".join(LAYOUTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_shard0_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k6_shard0_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    with torch.inference_mode():
        res = {"card": card, "rows": sweep(args.models.split(","), args.layouts.split(","), log)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
