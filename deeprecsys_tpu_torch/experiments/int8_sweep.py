"""Mapping sweep of the int8 lookups K1-int8 and K4 on one card.

    python -m deeprecsys_tpu_torch.experiments.int8_sweep [--json PATH] [--models rm1,rm2]
    python -m deeprecsys_tpu_torch.experiments.int8_sweep --probe [--json PATH]

``ops/csrc/embedding_bag_int8.cu`` is built with only the mappings that
``ops.embedding.k1_launch_plan(..., torch.int8)`` and ``k4_launch_plan``
pick. This script chose them: it writes translation units into
``build/int8_sweep/`` that include that source and add one C entry point
over a wider set of instances (lanes a row, rows a lane a step, the load
hint), builds them (``experiments.sweep_build``), holds every instance
to its plain version at every zoo shape (K1-int8 bit for bit, K4 within
``rowwise_tolerance``), and times it: bf16 output, batch 512, full-size
tables, 8 batches of uniform ids (the port's generator) and 8 of zipf(1.2)
ids (``experiments.skew_bench.zipf_stream``). Beside each time it prints
the instance's registers and spills (ptxas), the shipped wrapper's time
and K1's on a bf16 table of the same rows, on the same ids. ``--probe``
runs ``straddle_probe`` instead: K4 beside K1-int8 and K1 on rm1's ids
moved onto rows that stay inside or cross 64-byte blocks.

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

KERNELS = (("K1-int8", 32), ("K1-int8", 64), ("K4", 32), ("K4", 64))
ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def instances(kernel: str, d: int, short: bool) -> list:
    """``(lanes a row, bags a warp, rows a lane, hint)`` of the sweep: short
    bags (L <= 8) take a slot each (G = 32 / lanes), U 1 or 2; long bags 1
    or 4 a warp, U 1-4; each with ``load16``'s hint and without.
    K1-int8's lanes take 16 or 32 bytes of a row, K4's 16, 8 or 4 values
    (short bags) or 32, 16 or 8 (long bags)."""
    if kernel == "K1-int8":
        lanes = (d // 16, d // 32)
    else:
        lanes = (d // 16, d // 8, d // 4) if short else (d // 32, d // 16, d // 8)
    shapes = ([(lpr, 32 // lpr, u) for lpr in lanes for u in (1, 2)] if short
              else [(lpr, g, u) for lpr in lanes for g in (1, 4) for u in (1, 2, 3, 4)])
    return [(lpr, g, u, h) for lpr, g, u in shapes for h in (False, True)]


def _template(d: int, inst) -> str:
    lpr, g, u, h = inst
    return f"{d}, {lpr}, {g}, {u}, {str(h).lower()}"


def _source(kernel: str, d: int, src: Path) -> str:
    launch = "launch_int8" if kernel == "K1-int8" else "launch_rowwise"
    args = "table, scale, a" if kernel == "K1-int8" else "table, a"
    cases = "\n".join(
        f"  if (lpr == {inst[0]} && g == {inst[1]} && u == {inst[2]} && h == {int(inst[3])}) "
        f"return {launch}<__nv_bfloat16, {_template(d, inst)}>({args});"
        for inst in dict.fromkeys(instances(kernel, d, True) + instances(kernel, d, False)))
    return f"""#include "{src}"
extern "C" int drs_sweep(int lpr, int g, int u, int h, const void* table, const void* scale,
                         const void* offsets, const void* indices, void* out, int64_t n_bags,
                         int T, int L, int grid, void* stream) {{
  const Args a = make_args(offsets, indices, nullptr, out, n_bags, T, L, grid, stream);
{cases}
  return (int)cudaErrorInvalidValue;
}}
"""


def build_all(log) -> dict:
    """One library a (kernel, d), compiled in parallel: {(kernel, d): (CDLL, ptxas lines)}."""
    from deeprecsys_tpu_torch.ops import _build

    src = _build.CSRC / "embedding_bag_int8.cu"
    stems = {f"{kernel.replace('-', '_').lower()}_{d}": (kernel, d) for kernel, d in KERNELS}
    built = build_units("int8_sweep", {stem: _source(*key, src) for stem, key in stems.items()},
                        "drs_sweep", ARGTYPES)
    libs = {stems[stem]: lib_lines for stem, lib_lines in built.items()}
    for key, (_, lines) in libs.items():
        log(f"{key[0]} d={key[1]}: {len(lines)} instances; ptxas " + "; ".join(lines))
    return libs


def _call(lib, inst, table, scale, offsets, indices):
    lpr, g, u, h = inst
    B, T, L = indices.shape
    d = table.shape[1] - (0 if scale is not None else 4)
    out = torch.empty((B, T, d), dtype=torch.bfloat16, device=table.device)
    tasks = -(-(B * T) // g)
    err = lib.drs_sweep(lpr, g, u, int(h), table.data_ptr(),
                        None if scale is None else scale.data_ptr(), offsets.data_ptr(),
                        indices.data_ptr(), out.data_ptr(), B * T, T, L, max(1, -(-tasks // 8)),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep instance {inst} failed to launch ({err})")
    return out


def _ptxas_of(lines: list, kernel: str, d: int, inst) -> str:
    name = "embedding_bag_int8_kernel" if kernel == "K1-int8" else \
        "embedding_bag_int8_rowwise_kernel"
    return ptxas_of(lines, f"{name}<bf16, {d}, {inst[0]}, {inst[1]}, {inst[2]}, {int(inst[3])}>")


def sweep_model(name: str, libs: dict, log) -> list:
    """Every instance at ``name``'s shape, on its uniform and zipf ids."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.kernel_bench import (
        _us, int8_id_streams, measure, random_int8_tables)
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops.embedding import (
        embedding_bag, embedding_bag_int8, embedding_bag_int8_reference,
        embedding_bag_int8_rowwise, embedding_bag_int8_rowwise_reference, rowwise_tolerance)

    device, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = zoo.get_config(name)
    d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
    g = torch.Generator(device=device).manual_seed(0)
    t = random_int8_tables(cfg, g, device)
    offsets = table_offsets(cfg, device)
    ids = int8_id_streams(cfg, device)
    table16 = torch.empty((cfg.total_rows, d), dtype=bf16, device=device).uniform_(
        -0.05, 0.05, generator=g)
    rows = []
    for kind, batches in ids.items():
        i0, args = batches[0], [(i,) for i in batches]
        k1 = measure(lambda i: embedding_bag(table16, offsets, i), args)["kernel_ms"]
        shipped = {
            "K1-int8": measure(lambda i: embedding_bag_int8(t["q"], t["scale"], offsets, i,
                                                            compute_dtype=bf16), args),
            "K4": measure(lambda i: embedding_bag_int8_rowwise(t["qrows"], offsets, i,
                                                               compute_dtype=bf16), args)}
        want8 = embedding_bag_int8_reference(t["q"], t["scale"], offsets, i0, compute_dtype=bf16)
        want4 = embedding_bag_int8_rowwise_reference(t["qrows"], offsets, i0, compute_dtype=bf16)
        tol4 = None
        for kernel in ("K1-int8", "K4"):
            lib, lines = libs[(kernel, d)]
            table, scale = (t["q"], t["scale"]) if kernel == "K1-int8" else (t["qrows"], None)
            for inst in instances(kernel, d, L <= 8):
                got = _call(lib, inst, table, scale, offsets, i0)
                if kernel == "K1-int8":
                    ok = torch.equal(got, want8)
                else:
                    if tol4 is None:
                        tol4 = rowwise_tolerance(got, want4, t["qrows"], offsets, i0)
                    ok = bool(((got.float() - want4.float()).abs() <= tol4).all())
                if not ok:
                    raise AssertionError(f"{kernel} {inst} disagrees with its plain version "
                                         f"at {name} ({kind} ids)")
                ms = measure(lambda i: _call(lib, inst, table, scale, offsets, i),
                             args)["kernel_ms"]
                row = {"model": name, "ids": kind, "kernel": kernel, "d": d, "L": L,
                       "lanes_per_row": inst[0], "bags_per_warp": inst[1],
                       "rows_per_lane": inst[2], "hint": inst[3], "ms": ms,
                       "shipped_ms": shipped[kernel]["kernel_ms"], "k1_bf16_ms": k1,
                       "ptxas": _ptxas_of(lines, kernel, d, inst)}
                rows.append(row)
                log(f"{name} {kind} {kernel} lanes/row {inst[0]} G {inst[1]} U {inst[2]} "
                    f"hint {int(inst[3])}: {_us(ms)} (shipped {_us(row['shipped_ms'])}, "
                    f"K1 bf16 {_us(k1)}); {row['ptxas']}")
    del t, table16, ids
    torch.cuda.empty_cache()
    return rows


def straddle_probe(log, name: str = "rm1") -> dict:
    """K4, K1-int8 and K1 on three id sets of ``name``'s shape (uniform ids
    of the port's generator, 8 batches): the ids as drawn, each moved up to
    the nearest row whose d + 4 bytes lie inside one 64-byte block of the
    table, and to the nearest row that crosses a 64-byte boundary. Half of
    a row-wise table's rows cross one at d = 32 (36 r mod 64 > 28 for 8 of
    every 16 rows), none of K1-int8's or K1's; so if K4's time follows the
    crossings and the others' do not, K4 pays for the DRAM blocks a row
    touches, not for its own work."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.kernel_bench import (
        _us, int8_id_streams, measure, random_int8_tables)
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops.embedding import (
        embedding_bag, embedding_bag_int8, embedding_bag_int8_rowwise)

    device, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = zoo.get_config(name)
    d, rb = cfg.sparse_feature_size, cfg.sparse_feature_size + 4
    g = torch.Generator(device=device).manual_seed(0)
    t = random_int8_tables(cfg, g, device)
    table16 = torch.empty((cfg.total_rows, d), dtype=bf16, device=device).uniform_(
        -0.05, 0.05, generator=g)
    offsets = table_offsets(cfg, device)
    if t["qrows"].data_ptr() % 64:
        raise AssertionError("the probe needs a table on a 64-byte boundary")
    rows = torch.as_tensor(cfg.scaled_rows, device=device)[None, :, None]
    drawn = int8_id_streams(cfg, device)["uniform"]

    def moved(ids, inside: bool):
        out = ids.clone()
        done = torch.zeros_like(ids, dtype=torch.bool)
        for k in range(16):  # 36 r mod 64 (68 r mod 64) repeats every 16 rows
            cand = (ids.long() + k) % rows
            off = ((cand + offsets.long()[None, :, None]) * rb) % 64
            ok = ((off + rb <= 64) == inside) & ~done
            out = torch.where(ok, cand.to(torch.int32), out)
            done |= ok
        assert bool(done.all())
        return out

    res = {}
    for kind, batches in (("drawn", drawn), ("inside", [moved(i, True) for i in drawn]),
                          ("crossing", [moved(i, False) for i in drawn])):
        args = [(i,) for i in batches]
        res[kind] = {
            "K4": measure(lambda i: embedding_bag_int8_rowwise(t["qrows"], offsets, i,
                                                               compute_dtype=bf16),
                          args)["kernel_ms"],
            "K1-int8": measure(lambda i: embedding_bag_int8(t["q"], t["scale"], offsets, i,
                                                            compute_dtype=bf16),
                               args)["kernel_ms"],
            "K1": measure(lambda i: embedding_bag(table16, offsets, i), args)["kernel_ms"]}
        log(f"probe {name} {kind} ids: " + "; ".join(f"{k} {_us(v)}" for k, v in res[kind].items()))
    del t, table16
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--models", type=str, default=",".join(zoo.MODEL_NAMES))
    p.add_argument("--probe", action="store_true",
                   help="only straddle_probe at rm1: no instances built or swept")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[int8_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    with torch.inference_mode():
        if args.probe:
            res = {"card": card, "probe": straddle_probe(log)}
        else:
            libs = build_all(log)
            res = {"card": card, "rows": [r for name in args.models.split(",")
                                          for r in sweep_model(name, libs, log)]}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
