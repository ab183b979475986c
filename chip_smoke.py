#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeprecsys_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deeprecsys_tpu_torch/ops/csrc/`` (one
``nvcc`` a source, all started together), checks K1, the pooled lookup, at
every zoo model's shape and K3, DIEN's RNN scan, at DIEN's shape against
their plain PyTorch versions, and checks all eight zoo models against the
JAX package's outputs stored in ``tests/golden/torch_port_{rm1,zoo}.npz``.
Then it drives the models at full width (bf16, batch 512):

- rm1 through ``get_model(...).apply`` and the standalone CLI loop, timed
  against the plain path;
- rm1 through the serving stack (``serving.run_serving``: load generator,
  engines on their own CUDA streams, aggregator) at the canonical
  DeepRecSys point, with 1 and with 4 engines; payload requests through an
  engine, held against ``model.apply``; a short DeepRecSched tuning run;
  and dien served through ``main.py --queue`` (K1 and K3);
- rm2, rm3, wnd, mtwnd, ncf, din and dien through ``get_model(...).apply``,
  three forwards each, checked against the plain path and timed, each
  model's table freed before the next; dien also through the CLI loop.

Each kernel is timed beside its plain version, its bound and one PyTorch
call computing the same function (``F.embedding_bag`` at every zoo shape,
cuDNN's tanh RNN at DIEN's), from ``deeprecsys_tpu_torch/kernel_bench.py``.

Phases run in order and any failure raises, so the script exits non-zero
and never prints the closing line. Without a CUDA card it exits non-zero
at once. It imports no JAX and nothing of the JAX package: only
``deeprecsys_tpu_torch``.

The last three lines are the card's ``name, power.limit`` as nvidia-smi
gives them, ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deeprecsys_tpu_torch import ServingConfig, bridge, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.kernel_bench import (
    HBM_BYTES_PER_S, k1_bound, k1_library, k3_bound, k3_library, measure, ptxas_summary)
from deeprecsys_tpu_torch.models import get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import Batch, table_offsets
from deeprecsys_tpu_torch.ops import (
    _build, embedding_bag, embedding_bag_reference, rnn_scan, rnn_scan_reference)
from deeprecsys_tpu_torch.ops.embedding import pooled_tolerance
from deeprecsys_tpu_torch.ops.rnn import KERNEL_HIDDEN, rnn_scan_tolerance
from deeprecsys_tpu_torch.serving import ServiceRequest, run_serving
from deeprecsys_tpu_torch.serving.engine import ComputeEngine
from deeprecsys_tpu_torch.serving.packets import ERR_OK, ERR_PAYLOAD
from deeprecsys_tpu_torch.utils.devices import synchronize

ROOT = Path(__file__).resolve().parent

FIXTURE = ROOT / "tests" / "golden" / "torch_port_rm1.npz"
ZOO_FIXTURE = ROOT / "tests" / "golden" / "torch_port_zoo.npz"
# The kernels, with the JAX op each replaces. K1's op is the fused gather +
# sum (its XLA gather is at :794; the Pallas kernels that computed it were
# removed in commit 5ad96f1); K3's is the scan of basic_rnn_scan.
KERNELS = {
    "embedding_bag": {"source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag.cu",
                      "replaces": "deeprecsys_tpu/ops/embedding.py:770"},
    "rnn_scan": {"source": "deeprecsys_tpu_torch/ops/csrc/rnn_scan.cu",
                 "replaces": "deeprecsys_tpu/ops/rnn.py:45"},
}
ZOO = ("rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")
TIMED_ITERS = 100
# Port vs the JAX fixtures. rm1: f32 as the golden outputs; bf16 one bf16
# ulp of a sigmoid score in [0.5, 1), as tests/test_torch_dlrm.py holds it.
# The other models: f32 rtol and atol 1e-5, bf16 two bf16 ulps of the
# output's largest magnitude (bf16_atol), as tests/test_torch_models.py.
F32_RTOL = 1e-5
F32_ATOL = 1e-5
BF16_ATOL = 2.0 ** -8
# K3 against its plain loop, run free over all T steps (each step also
# held, teacher-forced, to rnn_scan_tolerance): two f32 summation orders
# of the recurrent dot drift apart by ~1e-6 over 40 steps in f32 and by
# one bf16 ulp (2^-8 for |h| in [0.5, 1)) in bf16, measured on the CPU;
# the bounds leave a factor of ~10 and 2.
K3_F32_ATOL = 1e-5
K3_BF16_ATOL = 2.0 ** -7
# K3 at DIEN's shape is checked on inputs from this many seeds, so that the
# margin under K3_BF16_ATOL is read on more than one draw.
K3_SEEDS = 4
BATCH = 512
# Full-size tables; a CPU rehearsal of the forward phases sets it larger.
TABLE_SCALE = 1
DIEN_T = 40  # dien's behaviour tables: the scan length
# The canonical DeepRecSys serving point (BASELINE.md): query sizes
# ~N(165, 16) capped at 1024, sub-batches of 32, Poisson arrivals 10 ms
# apart on average.
SERVING_POINT = {"batch_size_distribution": "normal", "avg_mini_batch_size": 165,
                 "var_mini_batch_size": 16, "max_mini_batch_size": 1024,
                 "sub_task_batch_size": 32, "avg_arrival_rate_ms": 10.0}
SERVE_QUERIES = 200
DIEN_QUERIES = 50


def _log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _bf16(params: dict) -> dict:
    return bridge.tree_map(lambda t: t.bfloat16(), params)


def bf16_atol(want: np.ndarray) -> float:
    """Two bf16 ulps of the largest |value| of ``want``."""
    big = max(float(np.abs(want).max()), float(np.finfo(np.float32).tiny))
    return 2.0 * 2.0 ** (np.floor(np.log2(big)) - 7)


def _reset_counts():
    embedding_bag.kernel_launches = 0
    rnn_scan.kernel_launches = 0


def _counts() -> dict:
    return {"embedding_bag": embedding_bag.kernel_launches,
            "rnn_scan": rnn_scan.kernel_launches}


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


def phase_build() -> dict:
    """Build every kernel, one nvcc a source, all at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, b in builds.items():
        how = f"built in {b.seconds:.2f} s" if b.seconds else "reused from an earlier build"
        _log(f"[2 build] {b.path.name}: {how}; ptxas (template arguments: registers, "
             f"spills): " + "; ".join(ptxas_summary(b.log)))
    _log(f"[2 build] all kernels in {time.perf_counter() - t0:.2f} s")
    return builds


def kernel_cases(device, cfg, B: int, tail: int | None, seed: int) -> float:
    """K1 against embedding_bag_reference for bf16 and f32 tables of
    ``cfg``'s rows, width and pooling, with and without a mask. ``tail``:
    ids drawn from the last ``tail`` rows of each table (reaching the far
    end of the fused table); None = the port's generator. Returns the max
    |error|."""
    rows, T, L, d = cfg.scaled_rows, cfg.num_tables, cfg.num_indices_per_lookup, \
        cfg.sparse_feature_size
    g = torch.Generator(device=device).manual_seed(seed)
    offsets = table_offsets(cfg, device)
    if tail is None:
        indices = torch.as_tensor(
            RecDataGenerator(cfg, seed=seed).generate_batch(B).indices).to(device)
    else:
        last = torch.as_tensor(rows, dtype=torch.int64, device=device)[None, :, None] - 1
        indices = (last - torch.randint(0, tail, (B, T, L), generator=g,
                                        device=device)).to(torch.int32)
    mask = torch.rand((B, T, L), generator=g, device=device) < 0.7
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        table = torch.empty((sum(rows), d), dtype=dt, device=device)
        table.uniform_(-1.0, 1.0, generator=g)
        nbytes = table.numel() * table.element_size()
        for m in (None, mask):
            what = (f"{cfg.model_name}: {sum(rows)} x {d} {str(dt)[6:]} table "
                    f"({nbytes / 1e9:.3f} GB), B={B} T={T} L={L}, "
                    f"mask={'yes' if m is not None else 'no'}")
            got = embedding_bag(table, offsets, indices, mask=m)
            synchronize(device)
            want = embedding_bag_reference(table, offsets, indices, mask=m)
            err = _check_pooled(got, want, table, offsets, indices, m, what)
            worst = max(worst, err)
            _log(f"[3 kernel] K1 ok {what}: max |err| {err:.3e}")
        del table
        torch.cuda.empty_cache()
    return worst


def phase_kernel(device) -> float:
    """K1 at every zoo model's full shape (rm1's: 8 x 4 M rows, d = 32,
    L = 80), batch 512."""
    err = 0.0
    for seed, name in enumerate(zoo.MODEL_NAMES):
        err = max(err, kernel_cases(device, zoo.get_config(name), BATCH, None, seed=seed))
    # 40 M rows: the bf16 table is 2.56 GB, the f32 one 5.12 GB, so the last
    # rows lie past 2^31 bytes.
    big = zoo.get_config("rm1").replace(embedding_rows=(5_000_000,) * 8)
    kernel_cases(device, big, 64, 100_000, seed=100)
    return err


def rnn_inputs(device, T: int, B: int, dtype: torch.dtype, seed: int) -> dict:
    """Random inputs of K3 at (T, B, 64): xproj ~ N(0, 1), W with the
    1/sqrt(H) init, a nonzero bias, seq_lengths in [0, T] (0 and T among
    them) and an initial state."""
    g = torch.Generator(device=device).manual_seed(seed)
    H = KERNEL_HIDDEN
    lens = torch.randint(0, T + 1, (B,), generator=g, device=device, dtype=torch.int32)
    lens[:2] = torch.tensor([0, T], dtype=torch.int32)
    return {
        "xproj": torch.randn((T, B, H), generator=g, device=device),
        "h2h_w": (torch.randn((H, H), generator=g, device=device) / H ** 0.5).to(dtype),
        "h2h_b": (torch.randn((H,), generator=g, device=device) * 0.1).to(dtype),
        "h0": torch.randn((B, H), generator=g, device=device) * 0.5,
        "seq_lengths": lens,
    }


def rnn_cases(device, T: int, B: int, seed: int = 0) -> float:
    """K3 against rnn_scan_reference in f32 and bf16, with and without
    seq_lengths and h0. Each step is held, teacher-forced, to
    rnn_scan_tolerance, and the free-running scans to K3_*_ATOL. Returns
    the max |error| of the free-running scans."""
    worst = 0.0
    for dt, atol in ((torch.float32, K3_F32_ATOL), (torch.bfloat16, K3_BF16_ATOL)):
        inp = rnn_inputs(device, T, B, dt, seed)
        for use_lens in (False, True):
            for use_h0 in (False, True):
                h0 = inp["h0"] if use_h0 else None
                lens = inp["seq_lengths"] if use_lens else None
                args = (inp["xproj"], inp["h2h_w"], inp["h2h_b"], dt)
                got, last = rnn_scan(*args, h0=h0, seq_lengths=lens)
                synchronize(device)
                want, want_last = rnn_scan_reference(*args, h0=h0, seq_lengths=lens)
                what = (f"T={T} B={B} H={KERNEL_HIDDEN} {str(dt)[6:]}, "
                        f"seq_lengths={'yes' if use_lens else 'no'}, h0={'yes' if use_h0 else 'no'}")
                step, tol = rnn_scan_tolerance(got, inp["xproj"], inp["h2h_w"], inp["h2h_b"],
                                               h0=h0, seq_lengths=lens)
                step_err = (got.float() - step).abs()
                if got.dtype != dt or not bool((step_err <= tol).all()):
                    raise AssertionError(f"K3 step disagrees with its plain step ({what}): "
                                         f"{int((step_err > tol).sum())} elements over "
                                         f"tolerance, max |err| {step_err.max().item():.3e}")
                err = (got.float() - want.float()).abs().max().item()
                if err > atol or (last.float() - want_last.float()).abs().max().item() > atol:
                    raise AssertionError(f"K3 disagrees with its plain loop ({what}): "
                                         f"max |err| {err:.3e} > {atol:.1e}")
                worst = max(worst, err)
                _log(f"[3 kernel] K3 ok {what}: max |err| {err:.3e} (limit {atol:.1e}); "
                     f"teacher-forced max |err| {step_err.max().item():.3e}")
    return worst


def _zoo_fixture_params(stored, name: str, device) -> tuple[dict, Batch]:
    """The f32 params of ``name``'s fixture entry, redrawn from its seed,
    and its batch."""
    cfg = zoo.get_config(name, table_scale=2000)
    np_params = bridge.init_numpy(cfg, int(stored[f"{name}/seed"]))
    if not np.allclose(bridge.fingerprint(np_params), stored[f"{name}/fingerprint"],
                       rtol=1e-9, atol=0):
        raise AssertionError(f"{name}: numpy drew other weights from the fixture's seed "
                             "than when the fixture was built (fingerprint differs)")
    dense = stored[f"{name}/dense"] if f"{name}/dense" in stored.files else None
    batch = Batch(dense, stored[f"{name}/indices"]).to(device)
    return bridge.params_from_numpy(np_params, cfg, device), batch


def fixture_model(stored, name: str, device) -> dict:
    """``name`` at table_scale=2000, f32 and bf16, against the JAX outputs
    in the zoo fixture (and, for dien, ragged histories with an initial
    state). Returns the max |error| by output."""
    params32, batch = _zoo_fixture_params(stored, name, device)
    cases = [("", {})]
    if name == "dien":
        cases.append(("ragged_", {
            "seq_lengths": torch.as_tensor(stored["dien/seq_lengths"]).to(device),
            "initial_h": torch.as_tensor(stored["dien/initial_h"]).to(device)}))
    errs = {}
    for dtype, tag, params in (("float32", "f32", params32),
                               ("bfloat16", "bf16", _bf16(params32))):
        cfg = zoo.get_config(name, table_scale=2000, param_dtype=dtype, compute_dtype=dtype)
        model = get_model(cfg, device)
        for prefix, kw in cases:
            want = stored[f"{name}/out_{prefix}{tag}"]
            with torch.inference_mode():
                got = model.apply(params, batch, **kw).float().cpu().numpy()
            key = f"{prefix}{tag}"
            errs[key] = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
            ok = got.shape == want.shape and (
                np.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL) if tag == "f32"
                else np.allclose(got, want, rtol=0, atol=bf16_atol(want)))
            if not ok:
                raise AssertionError(f"port {name} {key} differs from the JAX fixture: "
                                     f"max |err| {errs[key]:.3e}")
    return errs


def phase_fixture(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stored = np.load(FIXTURE)
    params32 = bridge.params_from_numpy(
        bridge.unflatten({k: stored[k] for k in stored.files if k == "tables" or "/" in k}),
        zoo.get_config("rm1", table_scale=2000), device)
    batch = Batch(stored["dense"], stored["indices"]).to(device)
    errs = {}
    for dtype, params, want, close in (
            ("float32", params32, stored["out_f32"],
             lambda g, w: np.allclose(g, w, rtol=F32_RTOL, atol=0)),
            ("bfloat16", _bf16(params32), stored["out_bf16"],
             lambda g, w: np.allclose(g, w, rtol=0, atol=BF16_ATOL))):
        cfg = zoo.get_config("rm1", table_scale=2000, param_dtype=dtype, compute_dtype=dtype)
        with torch.inference_mode():
            got = get_model(cfg, device).apply(params, batch).float().cpu().numpy()
        errs[f"rm1 {dtype}"] = float(np.abs(got - want).max())
        if got.shape != want.shape or not close(got, want):
            raise AssertionError(f"port rm1 {dtype} differs from the JAX fixture: "
                                 f"max |err| {errs[f'rm1 {dtype}']:.3e}")
        _log(f"[4 fixture] rm1 table_scale=2000 {dtype} batch {want.shape[0]} matches "
             f"JAX: max |err| {errs[f'rm1 {dtype}']:.3e}")
    zoo_stored = np.load(ZOO_FIXTURE)
    for name in ZOO:
        model_errs = fixture_model(zoo_stored, name, device)
        errs.update({f"{name} {k}": v for k, v in model_errs.items()})
        _log(f"[4 fixture] {name} table_scale=2000 matches JAX: max |err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in model_errs.items()))
    return errs


def _check_scores(out: torch.Tensor, shape: tuple, sigmoid: bool, what: str):
    o = out.float()
    ok = tuple(o.shape) == shape and bool(torch.isfinite(o).all())
    ok = ok and bool(((o >= 0) & (o <= 1)).all() if sigmoid else (o >= 0).all())
    if not ok:
        raise AssertionError(f"{what}: scores not finite "
                             f"{'in [0, 1]' if sigmoid else '>= 0'} of shape {shape}")


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
            _check_scores(out, (BATCH, 1), True, "rm1 forward")
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
        _check_scores(out, (BATCH, 1), True, "main.py forward")
    _log(f"[5 forward] main.py standalone loop: {res['forwards']} forwards, "
         f"compute {res['compute_ms']:.3f} ms for 4 batches")
    return {"cfg": cfg, "model": model, "params": params, "batches": batches}


def _backend(device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _peak_gib(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _check_served(res, counts: dict, scans_per_execution: int, what: str,
                  drained: bool = False):
    """Every sub-request answered without an error (but those a tuning run's
    drain-and-settle removed from the queue, with ``drained``), and each
    kernel launched once a model execution (K3 twice for dien), warm-up
    included."""
    if res.engine_errors:
        raise AssertionError(f"{what}: engines failed: {res.engine_errors}")
    if res.error_responses != 0 or (
            res.num_responses > res.cpu_sub_requests if drained
            else res.num_responses != res.cpu_sub_requests):
        raise AssertionError(f"{what}: {res.num_responses} responses for "
                             f"{res.cpu_sub_requests} sub-requests, "
                             f"{res.error_responses} of them errors")
    want = {"embedding_bag": res.executions,
            "rnn_scan": scans_per_execution * res.executions}
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {want} for "
                             f"{res.executions} executions (warm-up included)")
    if not (np.isfinite(res.p95_ms) and res.measured_qps > 0):
        raise AssertionError(f"{what}: no latency or QPS measured")


def _served_line(res, counts: dict) -> str:
    return (f"QPS {res.measured_qps:.2f}; p50 {res.p50_ms:.3f} ms, p95 "
            f"{res.p95_ms:.3f} ms, p99 {res.p99_ms:.3f} ms; queue-wait p95 "
            f"{res.queue_wait_p95_ms:.3f} ms, inference p95 {res.inference_p95_ms:.3f} ms; "
            f"{res.cpu_requests} queries, {res.cpu_sub_requests} sub-requests, "
            f"{res.num_responses} responses, {res.error_responses} errors; executions a "
            f"bucket {res.bucket_counts} + {res.warmup_executions} warm-up; launches "
            f"{counts}; pacing error mean {res.pacing_error_mean_ms:.4f} ms, p99 "
            f"{res.pacing_error_p99_ms:.4f} ms; wall {res.wall_s:.2f} s")


def serve_rm1(device, engines: int, card: str) -> tuple[dict, dict]:
    """rm1 at the canonical point through ``run_serving``, each engine with
    its own params from its seed. Returns the result and the launches."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    scfg = ServingConfig(**SERVING_POINT, num_batches=SERVE_QUERIES,
                         inference_engines=engines, engine_backend=_backend(device))
    _reset_peak(device)
    _reset_counts()
    res = run_serving(cfg, scfg, settle_s=0.1)
    counts = _counts()
    _check_served(res, counts, 0, f"rm1 served by {engines} engine(s)")
    peak = _peak_gib(device)
    _log(f"[6 serving] rm1 table_scale={TABLE_SCALE} bf16, {engines} engine(s): "
         f"{_served_line(res, counts)}; peak device memory {peak:.3f} GiB [{card}]")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"engines": engines, **res.to_dict(), "peak_gib": peak}, counts


def serve_payloads(device, fwd: dict) -> tuple[float, dict]:
    """Payload requests through one rm1 engine on phase 5's params: their
    scores against ``model.apply`` on the same rows (bf16_atol: the bucket's
    GEMMs may take another cuBLAS algorithm than the reference batch's);
    an id past its table is answered ERR_PAYLOAD. Returns the max |error|
    and the launches."""
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device))
    data = RecDataGenerator(cfg, seed=4)
    payloads = [data.generate_batch(n) for n in (32, 17, 100)]
    bad = data.generate_batch(8)
    bad.indices[3, 5, 7] = cfg.scaled_rows[5]
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    _reset_counts()
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device=device, params=params)
    eng.start()
    ready = ready_q.get(timeout=120)
    if isinstance(ready, Exception):
        raise RuntimeError("the payload engine failed during setup") from ready
    for i, p in enumerate(payloads + [bad]):
        req_q.put(ServiceRequest(batch_id=i, batch_size=len(p.indices),
                                 arrival_time=time.time(), payload=p))
    req_q.put(None)
    got = {}
    for _ in range(len(payloads) + 1):
        r = resp_q.get(timeout=120)
        got[r.batch_id] = r
    eng.join(timeout=120)
    counts = _counts()
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    if counts != {"embedding_bag": executions, "rnn_scan": 0} or eng.error is not None:
        raise AssertionError(f"payload engine: launches {counts} for {executions} "
                             f"executions; error {eng.error!r}")
    if got[len(payloads)].error_code != ERR_PAYLOAD:
        raise AssertionError("an out-of-range id was not answered with ERR_PAYLOAD")
    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(payloads):
            want = model.apply(params, p.to(device)).float().cpu().numpy()
            r = got[i]
            if r.error_code != ERR_OK or r.scores is None or r.scores.shape != want.shape:
                raise AssertionError(f"payload {i}: error {r.error_code}, scores "
                                     f"{None if r.scores is None else r.scores.shape}")
            err = float(np.abs(r.scores - want).max())
            if err > bf16_atol(want):
                raise AssertionError(f"payload {i}: engine scores differ from "
                                     f"model.apply by {err:.3e} > {bf16_atol(want):.3e}")
            worst = max(worst, err)
    _log(f"[6 serving] rm1 payload requests of {[len(p.indices) for p in payloads]} rows "
         f"through one engine match model.apply on the same rows: max |err| {worst:.3e} "
         f"(limit bf16_atol); an id past table 5's {cfg.scaled_rows[5]} rows answered "
         f"ERR_PAYLOAD; launches {counts} for {executions} executions")
    return worst, counts


def serve_tuning(device, fwd: dict, card: str) -> tuple[dict, dict]:
    """A short DeepRecSched run on rm1 (one engine, phase 5's params): the
    hill climber over sub-batches of 32 and 64 picks one."""
    scfg = ServingConfig(**{**SERVING_POINT, "avg_arrival_rate_ms": 5.0},
                         num_batches=40, engine_backend=_backend(device),
                         tune_batch_qps=True, batch_configs=(32, 64), arr_steps=5,
                         sched_timeout=4, req_granularity=8, min_arr_range=2.0,
                         max_arr_range=20.0, target_latency_ms=25.0)
    _reset_counts()
    res = run_serving(fwd["cfg"], scfg, params=fwd["params"], settle_s=0.1)
    counts = _counts()
    if res.optimal_sub_batch not in scfg.batch_configs:
        raise AssertionError(f"tune_batch_qps picked {res.optimal_sub_batch}")
    _check_served(res, counts, 0, "rm1 tuning run", drained=True)
    _log(f"[6 serving] rm1 tune_batch_qps over {scfg.batch_configs}: optimal_sub_batch "
         f"{res.optimal_sub_batch}; after tuning {_served_line(res, counts)} [{card}]")
    return res.to_dict(), counts


def serve_dien(device, card: str) -> tuple[dict, dict]:
    """dien at full width through ``main.py --queue``, one engine."""
    _reset_peak(device)
    _reset_counts()
    res = port_main.main([
        "--model", "dien", "--param_dtype", "bfloat16", "--table_scale", str(TABLE_SCALE),
        "--queue", "--engine_backend", _backend(device), "--num_batches", str(DIEN_QUERIES),
        "--batch_size_distribution", "normal", "--avg_mini_batch_size", "165",
        "--var_mini_batch_size", "16", "--sub_task_batch_size", "32",
        "--avg_arrival_rate", "10"])
    counts = _counts()
    _check_served(res, counts, 2, "dien served by main.py --queue")
    peak = _peak_gib(device)
    _log(f"[6 serving] dien table_scale={TABLE_SCALE} bf16 through main.py --queue, 1 "
         f"engine: {_served_line(res, counts)}; peak device memory {peak:.3f} GiB [{card}]")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {**res.to_dict(), "peak_gib": peak}, counts


def phase_serving(device, fwd: dict, card: str) -> tuple[dict, dict]:
    """The serving stack on the card; each path's launches read around it.
    Returns the results and the launches summed over the paths."""
    t0 = time.perf_counter()
    launches = {"embedding_bag": 0, "rnn_scan": 0}
    out = {}
    for key, run in (("rm1_1", lambda: serve_rm1(device, 1, card)),
                     ("rm1_4", lambda: serve_rm1(device, 4, card)),
                     ("payload_err", lambda: serve_payloads(device, fwd)),
                     ("tune", lambda: serve_tuning(device, fwd, card)),
                     ("dien", lambda: serve_dien(device, card))):
        out[key], counts = run()
        for k, v in counts.items():
            launches[k] += v
    _log(f"[6 serving] all serving paths in {time.perf_counter() - t0:.1f} s")
    return out, launches


def _top(m: dict, n: int = 6) -> str:
    """The ``n`` kernels that took the most device time a call."""
    top = sorted(m["us_by_kernel"].items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{us:.2f} us {name}" for name, us in top)


def _fmt(m: dict) -> str:
    dev = "not measured" if m["device_ms"] is None else f"{m['device_ms'] * 1e3:.2f} us"
    return (f"device {dev} in {m['launches']:.0f} device ops, "
            f"wall {m['wall_ms'] * 1e3:.2f} us")


def _mean(runs: dict, keys, field):
    vals = [runs[k][field] for k in keys]
    return None if None in vals else sum(vals) / len(vals)


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _k1_runs(table, offsets, batches, cdt) -> dict:
    """K1 and its plain version on each batch's ids, in the order plain,
    kernel, kernel, plain, so drift over the run hits both alike."""
    def k1(idx):
        return embedding_bag(table, offsets, idx, compute_dtype=cdt)

    def plain(idx):
        return embedding_bag_reference(table, offsets, idx, compute_dtype=cdt)

    ids = [(b.indices,) for b in batches]
    runs = {key: measure(fn, ids, TIMED_ITERS) for key, fn in
            (("p1", plain), ("k1", k1), ("k2", k1), ("p2", plain))}
    runs["s1"] = measure(k1_library(table, offsets), ids, TIMED_ITERS)
    return runs


def _k1_summary(runs: dict, batches, table, offsets) -> dict:
    """K1's times (device where the trace has them, else wall) beside its
    bound on the first batch's ids and the library call's time."""
    B, T, L = batches[0].indices.shape
    d = table.shape[1]
    # The kernel runs: the median kernel, which a trace that dropped events
    # cannot pull down as it can the sum a call.
    k_dev, p_dev = _mean(runs, ("k1", "k2"), "kernel_ms"), _mean(runs, ("p1", "p2"), "device_ms")
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    n_rows = B * T * L
    bound = k1_bound(table, offsets, batches[0].indices, torch.bfloat16)
    use_dev = k_dev is not None and p_dev is not None and runs["s1"]["device_ms"] is not None
    k_ms = k_dev if use_dev else k_wall
    p_ms = p_dev if use_dev else p_wall
    lib_ms = runs["s1"]["device_ms"] if use_dev else runs["s1"]["wall_ms"]
    return {"shape": f"B={B} T={T} L={L} d={d}", "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "device": use_dev, "k_wall": k_wall, "p_wall": p_wall,
            "p_dev": p_dev, "bytes": bound["bytes"], "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "rows_per_s": n_rows / (k_ms / 1e3),
            "hbm_share": bound["bytes"] / (k_ms / 1e3) / HBM_BYTES_PER_S}


def _k1_line(s: dict, name: str, card: str) -> str:
    return (f"K1 {name} shape ({s['shape']}, {s['bytes'] / 1e6:.2f} MB moved): "
            f"{s['ms'] * 1e3:.2f} us ({'device' if s['device'] else 'wall'}), "
            f"{s['rows_per_s'] / 1e9:.3f} G rows/s, "
            f"{s['bytes'] / (s['ms'] / 1e3) / 1e9:.1f} GB/s = "
            f"{100 * s['hbm_share']:.1f}% of 3.35 TB/s; bound {s['bound_ms'] * 1e3:.2f} us "
            f"({s['bound_by']}); F.embedding_bag {s['library_ms'] * 1e3:.2f} us; wall per call "
            f"{s['k_wall'] * 1e3:.2f} us; plain version device {_us(s['p_dev'])}, "
            f"wall {s['p_wall'] * 1e3:.2f} us [{card}]")


def phase_times(device, fwd: dict, card: str) -> dict:
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    table = params["tables"]
    offsets = table_offsets(cfg, device)
    # Eight different batches (8 x 21 MB of rows > the 50 MB L2), so the
    # timed loop reads cold rows as a real stream would.
    data = RecDataGenerator(cfg, seed=3)
    batches = [b.to(device) for b in data.generate_batches(8, BATCH)]
    bf16 = torch.bfloat16
    B, T, L = batches[0].indices.shape

    def fwd_kernel(b):
        return model.apply(params, b)

    def fwd_plain(b):
        pooled = embedding_bag_reference(table, offsets, b.indices, compute_dtype=bf16)
        return model.apply_from_pooled(params, pooled, b)

    with torch.inference_mode():
        runs = _k1_runs(table, offsets, batches, bf16)
        bs = [(b,) for b in batches]
        for key, fn, args in (("fp1", fwd_plain, bs), ("fk1", fwd_kernel, bs),
                              ("fk2", fwd_kernel, bs), ("fp2", fwd_plain, bs)):
            runs[key] = measure(fn, args, TIMED_ITERS)

    k1 = _k1_summary(runs, batches, table, offsets)
    fk_wall, fp_wall = _mean(runs, ("fk1", "fk2"), "wall_ms"), _mean(runs, ("fp1", "fp2"), "wall_ms")
    fk_dev = _mean(runs, ("fk1", "fk2"), "device_ms")
    peak = torch.cuda.max_memory_allocated(device)
    _log(f"[7 times] card: {card}; {TIMED_ITERS} calls a run, runs in the order "
         "plain, kernel, kernel, plain")
    for key in ("p1", "k1", "k2", "p2", "s1", "fp1", "fk1", "fk2", "fp2"):
        _log(f"[7 times]   {key}: {_fmt(runs[key])} [{card}]; {', '.join(runs[key]['kernels'])}")
    _log(f"[7 times] {_k1_line(k1, 'rm1', card)}")
    _log(f"[7 times] rm1 forward, device time by kernel: {_top(runs['fk1'])} [{card}]")
    idle = "not measured" if fk_dev is None else f"{100 * (1 - fk_dev / fk_wall):.1f}%"
    _log(f"[7 times] rm1 forward batch {B} bf16: kernel path {fk_wall:.4f} ms = "
         f"{B / (fk_wall / 1e3):.0f} samples/s (device {_us(fk_dev)}, idle {idle}); "
         f"plain path {fp_wall:.4f} ms = {B / (fp_wall / 1e3):.0f} samples/s [{card}]")
    _log(f"[7 times] peak device memory (phase 7): {peak / 2**30:.3f} GiB [{card}]")
    return {"k1": k1,
            "fwd_wall_ms": fk_wall, "fwd_device_ms": fk_dev, "peak_bytes": peak}


def _tail_on_cpu(model, params: dict, pooled: torch.Tensor, batch: Batch) -> torch.Tensor:
    """The model after its lookup, on the CPU: there every kernel wrapper
    takes its plain version (dien's scans the plain loop)."""
    cpu = {k: bridge.tree_map(lambda t: t.cpu(), v) for k, v in params.items() if k != "tables"}
    return model.apply_from_pooled(cpu, pooled.cpu(), batch.to("cpu"))


def zoo_forward(device, name: str) -> dict:
    """``name`` at full width, bf16, batch 512: three forwards through
    ``get_model(...).apply`` with the launch counts read around them, the
    scores checked, and each forward held against the plain path (the
    plain lookup, then the rest of the model on the CPU). Returns the model
    and its state for ``zoo_times``."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    synchronize(device)
    init_s = time.perf_counter() - t0
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=1).generate_batches(3, BATCH)]
    want = {"embedding_bag": len(batches),
            "rnn_scan": 2 * len(batches) if cfg.model_type == "dien" else 0}
    with torch.inference_mode():
        _reset_counts()
        outs = [model.apply(params, b) for b in batches]
        synchronize(device)
        counts = _counts()
        if counts != want:
            raise AssertionError(f"{name}: kernel launches {counts}, expected {want} "
                                 f"for {len(batches)} forwards")
        offsets = table_offsets(cfg, device)
        worst, limit = 0.0, 0.0
        for b, out in zip(batches, outs):
            _check_scores(out, (BATCH, cfg.out_dim), sigmoid_output(cfg), f"{name} forward")
            pooled = embedding_bag_reference(params["tables"], offsets, b.indices,
                                             compute_dtype=torch.bfloat16)
            plain = _tail_on_cpu(model, params, pooled, b).float()
            limit = max(limit, bf16_atol(plain.numpy()))
            worst = max(worst, (out.float().cpu() - plain).abs().max().item())
        if worst > limit:
            raise AssertionError(f"{name} forward differs from its plain path: "
                                 f"{worst:.3e} > {limit:.3e}")
    nbytes = params["tables"].numel() * params["tables"].element_size()
    _log(f"[8 zoo] {name} table_scale={TABLE_SCALE} ({cfg.total_rows} x "
         f"{cfg.sparse_feature_size} bf16 table, {nbytes / 1e9:.3f} GB, init {init_s:.2f} s) "
         f"batch {BATCH}: {len(batches)} forwards, launches {counts}, scores "
         f"{tuple(outs[0].shape)} finite {'in [0, 1]' if sigmoid_output(cfg) else '>= 0'}, "
         f"max |kernel - plain path| {worst:.3e} (limit {limit:.3e})")
    return {"name": name, "cfg": cfg, "model": model, "params": params,
            "launches": counts}


def zoo_times(device, z: dict, card: str) -> dict:
    """The forward's wall and device time and idle share, K1 and its plain
    version at the model's shape, over eight batches."""
    cfg, model, params = z["cfg"], z["model"], z["params"]
    table, offsets = params["tables"], table_offsets(cfg, device)
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
    with torch.inference_mode():
        runs = _k1_runs(table, offsets, batches, torch.bfloat16)
        for key in ("fk1", "fk2"):
            runs[key] = measure(lambda b: model.apply(params, b), [(b,) for b in batches],
                                TIMED_ITERS)
    k1 = _k1_summary(runs, batches, table, offsets)
    wall, dev = _mean(runs, ("fk1", "fk2"), "wall_ms"), _mean(runs, ("fk1", "fk2"), "device_ms")
    idle = None if dev is None else 1 - dev / wall
    peak = torch.cuda.max_memory_allocated(device)
    name = z["name"]
    for key in ("p1", "k1", "k2", "p2", "s1", "fk1", "fk2"):
        _log(f"[8 zoo]   {name} {key}: {_fmt(runs[key])} [{card}]")
    _log(f"[8 zoo] {name} {_k1_line(k1, name, card)}")
    _log(f"[8 zoo] {name} forward, device time by kernel: {_top(runs['fk1'])} [{card}]")
    _log(f"[8 zoo] {name} forward batch {BATCH} bf16: wall {wall:.4f} ms = "
         f"{BATCH / (wall / 1e3):.0f} samples/s, device {_us(dev)} in "
         f"{runs['fk1']['launches']:.0f} device ops, idle "
         f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; peak device "
         f"memory {peak / 2**30:.3f} GiB [{card}]")
    return {"name": name, "fwd_wall_ms": wall, "fwd_device_ms": dev, "idle": idle,
            "k1": k1, "peak_bytes": peak, "device_ops": runs["fk1"]["launches"]}


def phase_zoo(device, card: str) -> tuple[list, dict]:
    """Each zoo model but rm1 at full width, its table freed before the
    next; then dien through main.py's loop. Returns the per-model times
    and the summed launch counts of these paths."""
    rows, launches = [], {"embedding_bag": 0, "rnn_scan": 0}
    for name in ZOO:
        torch.cuda.reset_peak_memory_stats(device)
        z = zoo_forward(device, name)
        for k, v in z["launches"].items():
            launches[k] += v
        rows.append(zoo_times(device, z, card))
        del z
        torch.cuda.empty_cache()

    _reset_counts()
    res = port_main.main(["--model", "dien", "--param_dtype", "bfloat16",
                          "--mini_batch_size", str(BATCH), "--num_batches", "2",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    counts = _counts()
    if counts != {"embedding_bag": res["forwards"], "rnn_scan": 2 * res["forwards"]}:
        raise AssertionError(f"main.py's dien loop: launches {counts} for "
                             f"{res['forwards']} forwards")
    for out in res["outputs"]:
        _check_scores(out, (BATCH, zoo.get_config("dien").out_dim), False,
                      "main.py dien forward")
    for k, v in counts.items():
        launches[k] += v
    _log(f"[8 zoo] main.py standalone loop, dien (no dense input): {res['forwards']} "
         f"forwards, launches {counts}, compute {res['compute_ms']:.3f} ms for 2 batches")
    torch.cuda.empty_cache()
    return rows, launches


def phase_rnn_times(device, card: str) -> dict:
    """K3 against its plain loop at DIEN's shape, bf16, in the order plain,
    kernel, kernel, plain; then cuDNN's tanh RNN on the same recurrence
    (kernel_bench.k3_library), and K3's bound."""
    inp = rnn_inputs(device, DIEN_T, BATCH, torch.bfloat16, seed=1)
    args = [(inp["xproj"], inp["h2h_w"], inp["h2h_b"], torch.bfloat16)]
    iters = 50
    with torch.inference_mode():
        runs = {key: measure(fn, args, iters) for key, fn in (
            ("p1", rnn_scan_reference), ("k1", rnn_scan), ("k2", rnn_scan),
            ("p2", rnn_scan_reference))}
        runs["s1"] = measure(k3_library(inp["h2h_w"], inp["h2h_b"]),
                             [(inp["xproj"].bfloat16(),)], iters)
    for key in ("p1", "k1", "k2", "p2", "s1"):
        _log(f"[9 K3 times]   {key}: {_fmt(runs[key])} [{card}]")
    k_dev, p_dev = _mean(runs, ("k1", "k2"), "kernel_ms"), _mean(runs, ("p1", "p2"), "device_ms")
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    bound = k3_bound(DIEN_T, BATCH, KERNEL_HIDDEN, torch.bfloat16)
    use_dev = None not in (k_dev, p_dev, runs["s1"]["device_ms"])
    lib_ms = runs["s1"]["device_ms" if use_dev else "wall_ms"]
    _log(f"[9 K3 times] K3 at T={DIEN_T} B={BATCH} H={KERNEL_HIDDEN} bf16 ({iters} calls a "
         f"run): device {_us(k_dev)}, wall {k_wall * 1e3:.2f} us a scan; bound "
         f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); plain loop device "
         f"{_us(p_dev)}, wall {p_wall * 1e3:.2f} us; cuDNN RNN "
         f"{lib_ms * 1e3:.2f} us ({'device' if use_dev else 'wall'}) [{card}]")
    return {"ms": k_dev if use_dev else k_wall, "plain_ms": p_dev if use_dev else p_wall,
            "library_ms": lib_ms, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    k1_err = phase_kernel(device)
    k3_errs = [rnn_cases(device, DIEN_T, BATCH, seed) for seed in range(K3_SEEDS)]
    k3_err = max(k3_errs)
    _log(f"[3 kernel] K3 at DIEN's shape, free-running max |err| by seed: "
         f"{', '.join(f'{e:.3e}' for e in k3_errs)}; worst {k3_err:.3e} = "
         f"{100 * k3_err / K3_BF16_ATOL:.1f}% of the bf16 limit {K3_BF16_ATOL:.3e}")
    phase_fixture(device)

    # rm1's main path: the counts are set to 0 just before it and read just after.
    torch.cuda.reset_peak_memory_stats(device)
    _reset_counts()
    fwd = phase_forward(device)
    launches = _counts()
    if launches["embedding_bag"] == 0:
        raise AssertionError("the main path never launched K1")
    # The serving paths, each read around itself.
    serving, serve_launches = phase_serving(device, fwd, card["card"])
    for k, v in serve_launches.items():
        launches[k] += v
    torch.cuda.reset_peak_memory_stats(device)
    times = phase_times(device, fwd, card["card"])
    del fwd
    torch.cuda.empty_cache()

    # The other models' paths, each read around itself.
    rows, zoo_launches = phase_zoo(device, card["card"])
    for k, v in zoo_launches.items():
        launches[k] += v
    if launches["rnn_scan"] == 0:
        raise AssertionError("dien's path never launched K3")
    k3 = phase_rnn_times(device, card["card"])

    _log(f"[10 summary] per model, bf16, batch {BATCH}, full-size tables [{card['card']}]:")
    _log("[10 summary]   model: forward wall ms, device ms, idle, K1 us (% of 3.35 TB/s, "
         "counting each distinct row once), K1 bound us, F.embedding_bag us, K1 plain us, "
         "peak GiB")
    rm1 = {"name": "rm1", "fwd_wall_ms": times["fwd_wall_ms"], "k1": times["k1"],
           "fwd_device_ms": times["fwd_device_ms"], "peak_bytes": times["peak_bytes"]}
    for r in [rm1] + rows:
        dev = r["fwd_device_ms"]
        idle = "not measured" if dev is None else f"{100 * (1 - dev / r['fwd_wall_ms']):.1f}%"
        _log(f"[10 summary]   {r['name']}: {r['fwd_wall_ms']:.4f}, "
             f"{'not measured' if dev is None else f'{dev:.4f}'}, {idle}, "
             f"{r['k1']['ms'] * 1e3:.2f} ({100 * r['k1']['hbm_share']:.1f}%), "
             f"{r['k1']['bound_ms'] * 1e3:.2f}, {r['k1']['library_ms'] * 1e3:.2f}, "
             f"{r['k1']['plain_ms'] * 1e3:.2f}, {r['peak_bytes'] / 2**30:.3f} [{card['card']}]")
    _log("[10 summary] serving, canonical point (sizes ~N(165, 16), sub-batch 32, 10 ms "
         "mean gap): engines, queries, QPS, p50/p95/p99 ms, queue-wait p95 ms, inference "
         "p95 ms, pacing error mean/p99 ms, peak GiB")
    for key in ("rm1_1", "rm1_4", "dien"):
        s = serving[key]
        _log(f"[10 summary]   {key.split('_')[0]}: {s.get('engines', 1)}, {s['cpu_requests']}, "
             f"{s['measured_qps']:.2f}, {s['p50_ms']:.3f}/{s['p95_ms']:.3f}/{s['p99_ms']:.3f}, "
             f"{s['queue_wait_p95_ms']:.3f}, {s['inference_p95_ms']:.3f}, "
             f"{s['pacing_error_mean_ms']:.4f}/{s['pacing_error_p99_ms']:.4f}, "
             f"{s['peak_gib']:.3f} [{card['card']}]")
    _log(f"[10 summary] chip_smoke took {time.perf_counter() - t_start:.1f} s after start-up")

    print(card_line())
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "embedding_bag", "route": "cuda", **KERNELS["embedding_bag"],
         "launches": launches["embedding_bag"], "max_abs_err": k1_err,
         **{k: times["k1"][k] for k in timed}},
        {"name": "rnn_scan", "route": "cuda", **KERNELS["rnn_scan"],
         "launches": launches["rnn_scan"], "max_abs_err": k3_err,
         **{k: k3[k] for k in timed}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
