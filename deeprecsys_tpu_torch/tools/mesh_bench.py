"""Forward throughput over a ``DxM`` mesh, and the hybrid splitter's
per-shard descriptor counters.

    python -m deeprecsys_tpu_torch.tools.mesh_bench --mesh 2x2 [--models rm1 rm2]
        [--batch 512] [--table-scale 0] [--iters 16] [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/mesh_bench.py:41-220``. For each model it runs
back-to-back ``parallel/sharding.py::sharded_apply`` forwards with the
tables row-sharded over the mesh's "model" axis and the batch over "data"
(bf16, the ids shifted by the iteration as the JAX tool's chained loop
does), timed with CUDA events around the loop (the host clock on the
CPU), and records, for each (data, model) factorization of the mesh's
size, the per-shard cold-gather descriptor counts of the native hybrid
splitter on a zipf stream: each real slot is one row fetch the owning
shard issues. ``tests/test_parallel.py`` asserts their divide-by-(D*M)
law; the record keeps it.

The mesh (``parallel/mesh.py::make_mesh``): distinct cards where
``torch.cuda.device_count() >= D*M``; otherwise ``["cuda:0"] * (D*M)``,
virtual shards of one card, labelled ``"virtual": true``: every sharded
launch and combine runs, but no scaling across cards shows. ``--device
cpu`` gives the CPU rehearsal (``["cpu"] * (D*M)``, also virtual; its
times are the host's). ``--table-scale 0`` means 1 (full size) on the card
and 512 on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.experiments.skew_bench import zipf_stream
from deeprecsys_tpu_torch.kernel_bench import wall_ms
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator
from deeprecsys_tpu_torch.ops.hotcold import split_hot_cold_hybrid
from deeprecsys_tpu_torch.parallel import make_mesh, shard_params, sharded_apply
from deeprecsys_tpu_torch.tools.common import (
    card_of, default_out, device_arg, write_record)
from deeprecsys_tpu_torch.utils.devices import resolve_device, synchronize


def parse_mesh(s: str) -> tuple[int, int]:
    try:
        d, m = s.lower().split("x")
        d, m = int(d), int(m)
        if d < 1 or m < 1:
            raise ValueError
        return d, m
    except ValueError:
        raise SystemExit(f"--mesh must be DxM (e.g. 2x4), got {s!r}")


def mesh_devices(device: torch.device, need: int) -> tuple[list, bool, str]:
    """The mesh's entries, whether its shards are virtual, and the label."""
    if device.type == "cpu":
        return ["cpu"] * need, True, "virtual shards of the host CPU (a rehearsal)"
    if torch.cuda.device_count() >= need:
        return [f"cuda:{i}" for i in range(need)], False, "distinct cards"
    return [str(device)] * need, True, "virtual shards of one card: no scaling across cards"


def factorizations(D: int, M: int) -> list:
    need = D * M
    out = [(1, need), (need, 1)] + ([(D, M), (M, D)] if D != M and D != 1 and M != 1
                                    else [(D, M)])
    return sorted(set(out))


def measure_mesh_model(name: str, mesh, batch: int, table_scale: int, iters: int,
                       trials: int = 2) -> dict:
    """Back-to-back forwards of ``name`` over ``mesh``: ms a forward (the
    smallest of ``trials`` loops of ``iters``), samples/s, the first call's
    time and how many forwards ran."""
    n_data = mesh.shape["data"]
    if batch % n_data:
        raise SystemExit(f"batch {batch} must divide the data axis {n_data}")
    cfg = zoo.get_config(name, table_scale=table_scale, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_pack=0)
    home = mesh.home
    model = get_model(cfg, home)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=home).manual_seed(0))
        sp = shard_params(params, mesh)
        del params
    host = RecDataGenerator(cfg, seed=0).generate_batch(batch)
    rows = torch.as_tensor(np.asarray(cfg.scaled_rows, dtype=np.int64)[None, :, None])
    idx = torch.as_tensor(host.indices).long()
    dense = None if host.dense is None else torch.as_tensor(host.dense).to(home)
    batches = [(Batch(dense=dense, indices=((idx + i) % rows).int().to(home)),)
               for i in range(iters)]
    fn = sharded_apply(model, mesh, has_dense=host.dense is not None)
    cuda = home.type == "cuda"
    with torch.inference_mode():
        t0 = time.perf_counter()
        fn(sp, *batches[0])
        synchronize(home)
        first_s = time.perf_counter() - t0
        runs = [wall_ms(lambda b: fn(sp, b), batches, iters, cuda=cuda) for _ in range(trials)]
    ms = min(runs)
    if ms <= 0:
        raise RuntimeError(f"{name}: non-positive time ({ms:.3g} ms a forward)")
    return {"model": name, "batch": batch, "latency_ms": ms, "trials_ms": runs,
            "samples_per_s": batch / (ms / 1000.0), "first_call_s": first_s,
            "forwards": 1 + trials * iters}


def descriptor_counters(name: str, table_scale: int, batch: int, facts) -> dict:
    """Per-shard real-slot counts of the hybrid splitter on a zipf stream,
    for each (D, M) of ``facts`` that divides the table and the batch."""
    cfg = zoo.get_config(name, table_scale=table_scale)
    total, T = int(cfg.total_rows), cfg.num_tables
    offsets = np.asarray(cfg.table_offsets)
    idx = zipf_stream(cfg, batch)
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2, batch_size=64)
    out = {}
    for D, M in facts:
        if total % M or batch % D:
            continue
        s = split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                  rows_per_shard=total // M)
        pad_seg = (batch // D) * T
        real = (s["cold_seg"] != pad_seg).sum(axis=-1)  # (D, M) real slots
        out[f"{D}x{M}"] = {
            "n_cold_total": int(s["n_cold"]),
            "per_chip_descriptors": real.astype(int).tolist(),
            "max_chip_descriptors": int(real.max()),
            "ideal_per_chip": float(s["n_cold"] / (D * M)),
        }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", required=True, help="DxM (data x model axes)")
    ap.add_argument("--models", nargs="+", default=["rm1", "rm2"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--table-scale", type=int, default=0,
                    help="0 = 1 (full size) on the card, 512 on the CPU")
    ap.add_argument("--iters", type=int, default=16)
    device_arg(ap)
    ap.add_argument("--out", default=str(default_out("mesh_bench")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)
    D, M = parse_mesh(args.mesh)
    need = D * M
    devices, virtual, label = mesh_devices(device, need)
    table_scale = args.table_scale or (512 if device.type == "cpu" else 1)
    mesh = make_mesh(D, M, devices=devices)
    print(f"# mesh {D}x{M} on {devices[0]} ({label}), table_scale={table_scale} [{card}]",
          flush=True)
    results, counters = {}, {}
    facts = factorizations(D, M)
    for m in args.models:
        r = measure_mesh_model(m, mesh, args.batch, table_scale, args.iters)
        results[m] = r
        print(f"# {m}: {r['latency_ms']:.4f} ms a forward ({r['samples_per_s']:.0f} samples/s) "
              f"over {D}x{M} ({label}), first call {r['first_call_s']:.2f} s [{card}]",
              flush=True)
        counters[m] = descriptor_counters(m, table_scale, args.batch, facts)
        for k, c in counters[m].items():
            print(f"#   splitter {k}: max shard {c['max_chip_descriptors']} descriptors vs "
                  f"ideal {c['ideal_per_chip']:.0f} (total {c['n_cold_total']})", flush=True)
    record = {"mesh": f"{D}x{M}", "devices": need, "entries": devices,
              "platform": device.type, "virtual": virtual, "label": label, "card": card,
              "table_scale": table_scale, "batch": args.batch, "results": results,
              "descriptor_counters": counters}
    write_record(args.out, record)
    return record


if __name__ == "__main__":
    main()
