#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeprecsys_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``deeprecsys_tpu_torch/ops/csrc/``,
checks it against its plain PyTorch version, checks the port's rm1 against
the JAX package's outputs stored in ``tests/golden/torch_port_rm1.npz``,
then drives rm1 at full width (8 x 4 M-row tables, bf16, batch 512) through
``get_model(...).apply``, the standalone CLI loop and 16 served queries,
and times the kernel and the forward. Phases run in order and any failure
raises, so the script exits non-zero and never prints the closing line.
Without a CUDA card it exits non-zero at once. It imports no JAX and
nothing of the JAX package: only ``deeprecsys_tpu_torch``.

The last three lines are the card's ``name, power.limit`` as nvidia-smi
gives them, ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# The port's serving module imports the shared load generator, which builds
# its native pacer at first import: keep that build inside the checkout.
os.environ.setdefault("DRS_NATIVE_CACHE", str(ROOT / "build" / "native"))

from deeprecsys_tpu_torch import ServingConfig, bridge, zoo  # noqa: E402
from deeprecsys_tpu_torch import main as port_main  # noqa: E402
from deeprecsys_tpu_torch.data import RecDataGenerator  # noqa: E402
from deeprecsys_tpu_torch.models import get_model  # noqa: E402
from deeprecsys_tpu_torch.models.base import Batch, table_offsets  # noqa: E402
from deeprecsys_tpu_torch.ops import _build, embedding_bag, embedding_bag_reference  # noqa: E402
from deeprecsys_tpu_torch.ops.embedding import pooled_tolerance  # noqa: E402
from deeprecsys_tpu_torch.serving import (  # noqa: E402
    model_batch_sizes, partition_query, pick_bucket, resolve_buckets)
from deeprecsys_tpu_torch.utils.devices import synchronize  # noqa: E402

FIXTURE = ROOT / "tests" / "golden" / "torch_port_rm1.npz"
KERNEL_SOURCE = "deeprecsys_tpu_torch/ops/csrc/embedding_bag.cu"
# The JAX op K1 replaces (its XLA gather is at :794; the Pallas kernels that
# computed it were removed in commit 5ad96f1).
KERNEL_REPLACES = "deeprecsys_tpu/ops/embedding.py:770"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet, 700 W)
# Port vs the JAX fixture: f32 as the golden outputs; bf16 one bf16 ulp of a
# sigmoid score in [0.5, 1), as tests/test_torch_dlrm.py holds it on the CPU.
F32_RTOL = 1e-5
BF16_ATOL = 2.0 ** -8
BATCH = 512
TIMED_ITERS = 100
# rm1's tables at full size; a CPU rehearsal of phase 5 sets it larger.
TABLE_SCALE = 1


def _log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _bf16(params: dict) -> dict:
    return {"tables": params["tables"].bfloat16(),
            **{k: [{n: t.bfloat16() for n, t in layer.items()} for layer in v]
               for k, v in params.items() if k != "tables"}}


def _check_pooled(got, want, table, offsets, indices, mask, what: str) -> float:
    tol = pooled_tolerance(got, want, table, offsets, indices, mask)
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"K1 disagrees with the plain version ({what}): "
                             f"max |err| {err.max().item():.3e}, "
                             f"{int((err > tol).sum())} elements over tolerance")
    return err.max().item()


# ---------------------------------------------------------------- phases

def phase_card() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    _log(f"[1 card] {name}; device count {count}; nvidia-smi: {card}")
    return {"kind": name, "count": count, "card": card}


def phase_build() -> _build.Build:
    b = _build.build("embedding_bag")
    lines = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    how = f"built in {b.seconds:.2f} s" if b.seconds else "reused from an earlier build"
    _log(f"[2 build] {b.path.name}: {how}")
    for ln in lines:
        _log(f"[2 build] ptxas: {ln}")
    return b


def kernel_cases(device, rows_per_table: int, T: int, B: int, L: int, d: int,
                 tail: int | None, seed: int) -> float:
    """K1 against embedding_bag_reference for bf16 and f32 tables, with and
    without a mask. ``tail``: ids drawn from the last ``tail`` rows of each
    table (reaching the far end of the fused table); None = the port's
    generator (rm1's sorted unique groups). Returns the max |error|."""
    rows = (rows_per_table,) * T
    g = torch.Generator(device=device).manual_seed(seed)
    offsets = torch.as_tensor(np.cumsum((0,) + rows[:-1]), dtype=torch.int32).to(device)
    if tail is None:
        cfg = zoo.get_config("rm1").replace(embedding_rows=rows, num_indices_per_lookup=L)
        indices = torch.as_tensor(
            RecDataGenerator(cfg, seed=seed).generate_batch(B).indices).to(device)
    else:
        indices = (rows_per_table - 1 - torch.randint(
            0, tail, (B, T, L), generator=g, device=device)).to(torch.int32)
    mask = torch.rand((B, T, L), generator=g, device=device) < 0.7
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        table = torch.empty((rows_per_table * T, d), dtype=dt, device=device)
        table.uniform_(-1.0, 1.0, generator=g)
        nbytes = table.numel() * table.element_size()
        for m in (None, mask):
            what = (f"{rows_per_table * T} x {d} {str(dt)[6:]} table ({nbytes / 1e9:.3f} GB), "
                    f"B={B} T={T} L={L}, mask={'yes' if m is not None else 'no'}")
            got = embedding_bag(table, offsets, indices, mask=m)
            synchronize(device)
            want = embedding_bag_reference(table, offsets, indices, mask=m)
            err = _check_pooled(got, want, table, offsets, indices, m, what)
            worst = max(worst, err)
            _log(f"[3 kernel] ok {what}: max |err| {err:.3e}")
        del table
        torch.cuda.empty_cache()
    return worst


def phase_kernel(device) -> float:
    # rm1's real shape: 8 x 4 M rows, d = 32, B = 512, L = 80.
    err = kernel_cases(device, 4_000_000, 8, BATCH, 80, 32, None, seed=0)
    # 40 M rows: the bf16 table is 2.56 GB, the f32 one 5.12 GB, so the last
    # rows lie past 2^31 bytes.
    kernel_cases(device, 5_000_000, 8, 64, 80, 32, 100_000, seed=1)
    return err


def phase_fixture(device) -> dict:
    stored = np.load(FIXTURE)
    params32 = bridge.params_from_numpy(bridge.unflatten(stored),
                                        zoo.get_config("rm1", table_scale=2000), device)
    batch = Batch(stored["dense"], stored["indices"]).to(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for dtype, params, want, close in (
            ("float32", params32, stored["out_f32"],
             lambda g, w: np.allclose(g, w, rtol=F32_RTOL, atol=0)),
            ("bfloat16", _bf16(params32), stored["out_bf16"],
             lambda g, w: np.allclose(g, w, rtol=0, atol=BF16_ATOL))):
        cfg = zoo.get_config("rm1", table_scale=2000, param_dtype=dtype, compute_dtype=dtype)
        with torch.inference_mode():
            got = get_model(cfg, device).apply(params, batch).float().cpu().numpy()
        errs[dtype] = float(np.abs(got - want).max())
        if got.shape != want.shape or not close(got, want):
            raise AssertionError(f"port rm1 {dtype} differs from the JAX fixture: "
                                 f"max |err| {errs[dtype]:.3e}")
        _log(f"[4 fixture] rm1 table_scale=2000 {dtype} batch {want.shape[0]} matches "
             f"JAX: max |err| {errs[dtype]:.3e}")
    return errs


def _check_scores(out: torch.Tensor, n: int, what: str):
    o = out.float()
    if o.shape != (n, 1) or not bool(torch.isfinite(o).all()) \
            or not bool(((o >= 0) & (o <= 1)).all()):
        raise AssertionError(f"{what}: scores not finite in [0, 1] of shape ({n}, 1)")


def phase_forward(device) -> dict:
    """rm1 at full width through get_model(...).apply and main.py's loop."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    data = RecDataGenerator(cfg, seed=1)
    batches = [b.to(device) for b in data.generate_batches(3, BATCH)]
    with torch.inference_mode():
        before = embedding_bag.kernel_launches
        outs = [model.apply(params, b) for b in batches]
        synchronize(device)
        if embedding_bag.kernel_launches - before != len(batches):
            raise AssertionError("K1 did not launch once per rm1 forward")
        offsets = table_offsets(cfg, device)
        worst = 0.0
        for b, out in zip(batches, outs):
            _check_scores(out, BATCH, "rm1 forward")
            pooled = embedding_bag_reference(params["tables"], offsets, b.indices,
                                             compute_dtype=torch.bfloat16)
            plain = model.apply_from_pooled(params, pooled, b)
            worst = max(worst, (out.float() - plain.float()).abs().max().item())
        if worst > BF16_ATOL:
            raise AssertionError(f"rm1 forward differs from its plain path: {worst:.3e}")
    _log(f"[5 forward] rm1 table_scale={TABLE_SCALE} bf16 batch {BATCH}: {len(batches)} forwards, "
         f"scores finite in [0, 1], max |kernel - plain path| {worst:.3e}")

    before = embedding_bag.kernel_launches
    res = port_main.main(["--model", "rm1", "--param_dtype", "bfloat16",
                          "--mini_batch_size", str(BATCH), "--num_batches", "4",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    if embedding_bag.kernel_launches - before != res["forwards"]:
        raise AssertionError("main.py's loop did not launch K1 once per forward")
    for out in res["outputs"]:
        _check_scores(out, BATCH, "main.py forward")
    _log(f"[5 forward] main.py standalone loop: {res['forwards']} forwards, "
         f"compute {res['compute_ms']:.3f} ms for 4 batches")
    return {"cfg": cfg, "model": model, "params": params, "batches": batches}


def phase_requests(device, model, params, cfg) -> list[float]:
    """16 queries at the canonical DeepRecSys operating point (BASELINE.md):
    sizes ~N(165, 16), split into sub-batches of 32, each padded to its
    bucket, run, and sliced back. Returns per-query latencies in ms."""
    scfg = ServingConfig(batch_size_distribution="normal", avg_mini_batch_size=165,
                         var_mini_batch_size=16, max_mini_batch_size=1024,
                         num_batches=16, sub_task_batch_size=32)
    sizes = model_batch_sizes(scfg, np.random.default_rng(scfg.seed))
    buckets = tuple(b for b in sorted(resolve_buckets(scfg))
                    if b <= scfg.max_mini_batch_size)
    data = RecDataGenerator(cfg, seed=2)
    queries = [data.generate_batch(int(n)) for n in sizes]

    def serve(q: Batch) -> torch.Tensor:
        scores, start = [], 0
        for part in partition_query(len(q.indices), scfg.sub_task_batch_size):
            pad = pick_bucket(buckets, part) - part
            sub = Batch(np.pad(q.dense[start:start + part], ((0, pad), (0, 0))),
                        np.pad(q.indices[start:start + part], ((0, pad), (0, 0), (0, 0))))
            scores.append(model.apply(params, sub.to(device))[:part])
            start += part
        return torch.cat(scores).float().cpu()  # the copy to the host waits for the card

    latencies = []
    with torch.inference_mode():
        for b in buckets:  # warm-up, as an engine warms its ladder
            if b <= scfg.sub_task_batch_size:
                serve(data.generate_batch(b))
        for n, q in zip(sizes, queries):
            t0 = time.perf_counter()
            out = serve(q)
            latencies.append((time.perf_counter() - t0) * 1000.0)
            _check_scores(out, int(n), "served query")
    _log(f"[6 requests] {len(sizes)} queries answered, {int(sizes.sum())} samples, "
         f"sizes {int(sizes.min())}-{int(sizes.max())}, buckets used "
         f"{sorted({pick_bucket(buckets, p) for n in sizes for p in partition_query(int(n), 32)})}")
    return latencies


def _measure(fn, args_list, iters: int = TIMED_ITERS) -> dict:
    """Per-call times of ``iters`` back-to-back calls cycling through
    ``args_list``, after a warm-up. ``wall_ms``: CUDA events around the loop,
    so host launch cost shows wherever it leaves the card idle. ``device_ms``:
    the summed durations of the device kernels and copies the calls ran,
    from a torch.profiler trace of a second loop (None when the trace holds
    no device activity)."""
    for a in args_list:
        fn(*a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / iters if dev else None
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches": len(dev) / iters, "kernels": sorted({e.name[:60] for e in dev})}


def _fmt(m: dict) -> str:
    dev = "not measured" if m["device_ms"] is None else f"{m['device_ms'] * 1e3:.2f} us"
    return (f"device {dev} in {m['launches']:.0f} device ops, "
            f"wall {m['wall_ms'] * 1e3:.2f} us")


def phase_times(device, fwd: dict, card: str, latencies: list[float]) -> dict:
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    table = params["tables"]
    offsets = table_offsets(cfg, device)
    # Eight different batches (8 x 21 MB of rows > the 50 MB L2), so the
    # timed loop reads cold rows as a real stream would.
    data = RecDataGenerator(cfg, seed=3)
    batches = [b.to(device) for b in data.generate_batches(8, BATCH)]
    B, T, L = batches[0].indices.shape
    d = cfg.sparse_feature_size
    bf16 = torch.bfloat16

    def k1(idx):
        return embedding_bag(table, offsets, idx, compute_dtype=bf16)

    def plain(idx):
        return embedding_bag_reference(table, offsets, idx, compute_dtype=bf16)

    def stock(idx):  # torch's own op, a timing baseline (its sum order differs)
        flat = (idx.long() + offsets.long()[None, :, None]).view(B * T, L)
        return torch.nn.functional.embedding_bag(flat, table, mode="sum")

    def fwd_kernel(b):
        return model.apply(params, b)

    def fwd_plain(b):
        pooled = embedding_bag_reference(table, offsets, b.indices, compute_dtype=bf16)
        return model.apply_from_pooled(params, pooled, b)

    # plain, kernel, kernel, plain: drift over the run hits both alike.
    runs = {}
    with torch.inference_mode():
        ids, bs = [(b.indices,) for b in batches], [(b,) for b in batches]
        for key, fn, args in (("p1", plain, ids), ("k1", k1, ids), ("k2", k1, ids),
                              ("p2", plain, ids), ("s1", stock, ids), ("fp1", fwd_plain, bs),
                              ("fk1", fwd_kernel, bs), ("fk2", fwd_kernel, bs),
                              ("fp2", fwd_plain, bs)):
            runs[key] = _measure(fn, args)

    def mean(keys, field):
        vals = [runs[k][field] for k in keys]
        return None if None in vals else sum(vals) / len(vals)

    k_dev, p_dev = mean(("k1", "k2"), "device_ms"), mean(("p1", "p2"), "device_ms")
    k_wall, p_wall = mean(("k1", "k2"), "wall_ms"), mean(("p1", "p2"), "wall_ms")
    fk_wall, fp_wall = mean(("fk1", "fk2"), "wall_ms"), mean(("fp1", "fp2"), "wall_ms")
    fk_dev = mean(("fk1", "fk2"), "device_ms")
    n_rows = B * T * L
    nbytes = n_rows * d * table.element_size() + n_rows * 4 + B * T * d * 2
    k_ms = k_dev if k_dev is not None else k_wall
    lat = np.asarray(latencies)
    peak = torch.cuda.max_memory_allocated(device)
    _log(f"[7 times] card: {card}; {TIMED_ITERS} calls a run, runs in the order "
         "plain, kernel, kernel, plain")
    for key in ("p1", "k1", "k2", "p2", "s1", "fp1", "fk1", "fk2", "fp2"):
        _log(f"[7 times]   {key}: {_fmt(runs[key])}; {', '.join(runs[key]['kernels'])}")
    _log(f"[7 times] K1 rm1 shape (B={B} T={T} L={L} d={d} bf16, {nbytes / 1e6:.2f} MB "
         f"moved): {k_ms * 1e3:.2f} us ({'device' if k_dev is not None else 'wall'}), "
         f"{n_rows / (k_ms / 1e3) / 1e9:.3f} G rows/s, "
         f"{nbytes / (k_ms / 1e3) / 1e9:.1f} GB/s = "
         f"{100 * nbytes / (k_ms / 1e3) / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s; "
         f"wall per call {k_wall * 1e3:.2f} us; plain version device "
         f"{'not measured' if p_dev is None else f'{p_dev * 1e3:.2f} us'}, "
         f"wall {p_wall * 1e3:.2f} us; F.embedding_bag {_fmt(runs['s1'])} [{card}]")
    idle = "not measured" if fk_dev is None else f"{100 * (1 - fk_dev / fk_wall):.1f}%"
    _log(f"[7 times] rm1 forward batch {B} bf16: kernel path {fk_wall:.4f} ms = "
         f"{B / (fk_wall / 1e3):.0f} samples/s (device idle {idle}); plain path "
         f"{fp_wall:.4f} ms = {B / (fp_wall / 1e3):.0f} samples/s [{card}]")
    _log(f"[7 times] per-query latency over {len(lat)} queries: p50 "
         f"{np.percentile(lat, 50):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms, "
         f"max {lat.max():.3f} ms [{card}]")
    _log(f"[7 times] peak device memory (phases 5-6): {peak / 2**30:.3f} GiB [{card}]")
    p_ms = p_dev if k_dev is not None and p_dev is not None else p_wall
    return {"ms": k_ms, "plain_ms": p_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    k1_err = phase_kernel(device)
    phase_fixture(device)

    torch.cuda.reset_peak_memory_stats(device)
    embedding_bag.kernel_launches = 0  # count the main path's launches only
    fwd = phase_forward(device)
    latencies = phase_requests(device, fwd["model"], fwd["params"], fwd["cfg"])
    launches = embedding_bag.kernel_launches
    if launches == 0:
        raise AssertionError("the main path never launched K1")

    times = phase_times(device, fwd, card["card"], latencies)
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "embedding_bag", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": k1_err,
        "ms": times["ms"], "plain_ms": times["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
