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

Then the trainer (phase 11): the training kernels K1b (the lookup's
backward), K5 (sparse row-wise AdaGrad) and K3b (the RNN's reverse scan)
against their plain versions at rm1's and DIEN's training shapes (batch 128,
full-size tables) in f32 and bf16; the JAX trainer's losses in
``tests/golden/torch_port_train.npz`` reproduced on the card;
``deeprecsys_tpu_torch.train.main`` at full width (f32, the CLI's dtype)
for rm1 dense, rm1 ``--sparse_tables`` and dien ``--sparse_tables``,
``TRAIN_STEPS`` steps each, the launches read around each run; the save ->
export -> ``main.py --checkpoint`` (standalone and ``--queue``) round trip
at ``--table_scale 100`` (the file format does not depend on the table's
size, and a 4 GB ``.npz`` a run is not worth the time); the three kernels'
times and each training step's wall, device time, idle share and peak
memory.

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
from deeprecsys_tpu_torch import train as port_train
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.kernel_bench import (
    HBM_BYTES_PER_S, k1_bound, k1_library, k1b_bound, k1b_library, k3_bound, k3_library,
    k3b_bound, k3b_library, k5_bound, k5_library, measure, ptxas_summary)
from deeprecsys_tpu_torch.models import get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import Batch, table_offsets
from deeprecsys_tpu_torch.ops import (
    _build, embedding_bag, embedding_bag_backward, embedding_bag_backward_reference,
    embedding_bag_reference, rnn_scan, rnn_scan_backward, rnn_scan_backward_reference,
    rnn_scan_reference, sparse_adagrad_step, sparse_adagrad_step_reference)
from deeprecsys_tpu_torch.ops.embedding import backward_tolerance, pooled_tolerance
from deeprecsys_tpu_torch.ops.rnn import KERNEL_HIDDEN, rnn_scan_tolerance
from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_tolerance
from deeprecsys_tpu_torch.serving import ServiceRequest, run_serving
from deeprecsys_tpu_torch.serving.engine import ComputeEngine
from deeprecsys_tpu_torch.serving.packets import ERR_OK, ERR_PAYLOAD
from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params, load_model_params
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
    # The trainer's: the gather's VJP under jax.value_and_grad (train.py:361),
    # the sparse table step's scatters, and the scan's VJP.
    "embedding_bag_backward": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_backward.cu",
        "replaces": "deeprecsys_tpu/ops/embedding.py:770"},
    "sparse_adagrad_step": {"source": "deeprecsys_tpu_torch/ops/csrc/sparse_adagrad.cu",
                            "replaces": "deeprecsys_tpu/train.py:258"},
    "rnn_scan_backward": {"source": "deeprecsys_tpu_torch/ops/csrc/rnn_scan_backward.cu",
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
TRAIN_FIXTURE = ROOT / "tests" / "golden" / "torch_port_train.npz"
TRAIN_FAMILIES = ("rm1", "wnd", "mtwnd", "ncf", "din", "dien")
TRAIN_BATCH = 128  # the train CLI's default batch
TRAIN_STEPS = 60
ROUND_TRIP_SCALE = 100
# The card's losses against the JAX trainer's (CPU, XLA) on the fixture's
# batches: f32 sums in other orders (cuBLAS, K1b's and K5's atomics) over
# three steps (measured at most 3.5e-7 on an H100, PERF.md), with a margin.
TRAIN_LOSS_RTOL = 1e-4
# K3b against its plain loop in f32: two orders of the 64-term dot carried
# over the scan's steps, within this share of the largest |delta|.
K3B_RTOL = 1e-5


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


def _wrappers() -> dict:
    """The kernel wrappers by KERNELS name (looked up at each call, so a CPU
    rehearsal can put counting shims in their place)."""
    return {"embedding_bag": embedding_bag, "rnn_scan": rnn_scan,
            "embedding_bag_backward": embedding_bag_backward,
            "sparse_adagrad_step": sparse_adagrad_step, "rnn_scan_backward": rnn_scan_backward}


def _reset_counts():
    for w in _wrappers().values():
        w.kernel_launches = 0


def _counts() -> dict:
    return {k: w.kernel_launches for k, w in _wrappers().items()}


def _want(**launches) -> dict:
    """Expected launches: those named, 0 for every other kernel."""
    return {k: launches.get(k, 0) for k in KERNELS}


def _add(total: dict, counts: dict):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


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
    sources = [Path(k["source"]).stem for k in KERNELS.values()]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
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
    want = _want(embedding_bag=res.executions, rnn_scan=scans_per_execution * res.executions)
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
    if counts != _want(embedding_bag=executions) or eng.error is not None:
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
    launches = _want()
    out = {}
    for key, run in (("rm1_1", lambda: serve_rm1(device, 1, card)),
                     ("rm1_4", lambda: serve_rm1(device, 4, card)),
                     ("payload_err", lambda: serve_payloads(device, fwd)),
                     ("tune", lambda: serve_tuning(device, fwd, card)),
                     ("dien", lambda: serve_dien(device, card))):
        out[key], counts = run()
        _add(launches, counts)
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
    want = _want(embedding_bag=len(batches),
                 rnn_scan=2 * len(batches) if cfg.model_type == "dien" else 0)
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
    rows, launches = [], _want()
    for name in ZOO:
        torch.cuda.reset_peak_memory_stats(device)
        z = zoo_forward(device, name)
        _add(launches, z["launches"])
        rows.append(zoo_times(device, z, card))
        del z
        torch.cuda.empty_cache()

    _reset_counts()
    res = port_main.main(["--model", "dien", "--param_dtype", "bfloat16",
                          "--mini_batch_size", str(BATCH), "--num_batches", "2",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    counts = _counts()
    if counts != _want(embedding_bag=res["forwards"], rnn_scan=2 * res["forwards"]):
        raise AssertionError(f"main.py's dien loop: launches {counts} for "
                             f"{res['forwards']} forwards")
    for out in res["outputs"]:
        _check_scores(out, (BATCH, zoo.get_config("dien").out_dim), False,
                      "main.py dien forward")
    _add(launches, counts)
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


# ---------------------------------------------------------------- training

def _train_inputs(device, name: str, seed: int):
    """``name``'s training-batch ids (the generator's, batch TRAIN_BATCH) and
    offsets at TABLE_SCALE, and a generator for the rest."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
    indices = torch.as_tensor(
        RecDataGenerator(cfg, seed=seed).generate_batch(TRAIN_BATCH).indices).to(device)
    return cfg, table_offsets(cfg, device), indices, torch.Generator(device=device).manual_seed(seed)


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_kernel_cases(device, name: str, seed: int) -> dict:
    """K1b and K5 against their plain versions at ``name``'s training shape
    (full-size table, batch TRAIN_BATCH, the generator's ids): K1b with f32
    and bf16 gradients, with and without a mask, K5 with f32 and bf16
    tables; each within its tolerance of the order of a row's adds. Returns
    the max |error| by kernel."""
    cfg, offsets, indices, g = _train_inputs(device, name, seed)
    R, T, d = cfg.total_rows, cfg.num_tables, cfg.sparse_feature_size
    B, _, L = indices.shape
    mask = torch.rand(indices.shape, generator=g, device=device) < 0.7
    errs = {"embedding_bag_backward": 0.0, "sparse_adagrad_step": 0.0}
    shape = f"{name}: R={R} d={d} B={B} T={T} L={L}"
    for gdt in (torch.float32, torch.bfloat16):
        grad = torch.randn((B, T, d), generator=g, device=device).to(gdt)
        for m in (None, mask):
            got = embedding_bag_backward(grad, offsets, indices, R, mask=m)
            synchronize(device)
            err = (got - embedding_bag_backward_reference(grad, offsets, indices, R, mask=m)).abs()
            del got
            tol = backward_tolerance(grad, offsets, indices, R, m)
            what = f"{shape}, g {str(gdt)[6:]}, mask={'yes' if m is not None else 'no'}"
            if not bool((err <= tol).all()):
                raise AssertionError(f"K1b disagrees with its plain version ({what}): max |err| "
                                     f"{err.max().item():.3e}, {int((err > tol).sum())} over")
            errs["embedding_bag_backward"] = max(errs["embedding_bag_backward"], err.max().item())
            _log(f"[11 train kernels] K1b ok {what}: max |err| {err.max().item():.3e} "
                 f"(limit: the order of each row's adds)")
            del err, tol
            _free(device)
    grad = torch.randn((B, T, d), generator=g, device=device) * 1e-2
    for tdt in (torch.float32, torch.bfloat16):
        table0 = ((torch.rand((R, d), generator=g, device=device) - 0.5) * 0.1).to(tdt)
        acc0 = torch.rand((R,), generator=g, device=device) * 1e-4
        table, acc = table0.clone(), acc0.clone()
        sparse_adagrad_step(table, acc, offsets, indices, grad, 0.1)
        synchronize(device)
        want_t, want_a = table0.clone(), acc0.clone()
        sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1)
        tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, indices, grad, 0.1)
        del table0, acc0
        err = (table.float() - want_t.float()).abs()
        acc_err = (acc - want_a).abs()
        what = f"{shape}, table {str(tdt)[6:]}"
        if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
            raise AssertionError(f"K5 disagrees with its plain version ({what}): max |err| "
                                 f"table {err.max().item():.3e}, acc {acc_err.max().item():.3e}")
        errs["sparse_adagrad_step"] = max(errs["sparse_adagrad_step"], err.max().item(),
                                          acc_err.max().item())
        _log(f"[11 train kernels] K5 ok {what}: max |err| table {err.max().item():.3e}, "
             f"accumulator {acc_err.max().item():.3e}")
        del table, acc, want_t, want_a, tol, acc_tol, err, acc_err
        _free(device)
    return errs


def _rnn_backward_inputs(device, T: int, B: int, dtype: torch.dtype, seed: int):
    """K3b's inputs at (T, B, 64): the f32 tanh values of a forward scan of
    ``rnn_inputs`` and a random gradient of every step's state."""
    inp = rnn_inputs(device, T, B, dtype, seed)
    w, b, h0 = inp["h2h_w"], inp["h2h_b"], inp["h0"]
    all_h, _ = rnn_scan_reference(inp["xproj"], w, b, torch.float32, h0=h0)
    prev = torch.cat([h0[None], all_h[:-1]])
    y = torch.tanh((inp["xproj"] + prev @ w.float()) + b.float())
    gh = torch.randn((T, B, KERNEL_HIDDEN), generator=torch.Generator(device=device)
                     .manual_seed(seed), device=device)
    return y, gh, w, inp["seq_lengths"]


def train_rnn_cases(device, T: int, B: int, seed: int = 0) -> float:
    """K3b against its plain reverse loop with f32 and bf16 weights, with
    and without seq_lengths, within K3B_RTOL of the largest |delta|."""
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        y, gh, w, lens = _rnn_backward_inputs(device, T, B, dt, seed)
        for m in (None, lens):
            delta, dh0 = rnn_scan_backward(y, gh, w, m)
            synchronize(device)
            want_d, want_h = rnn_scan_backward_reference(y, gh, w, m)
            scale = max(want_d.abs().max().item(), want_h.abs().max().item())
            err = max((delta - want_d).abs().max().item(), (dh0 - want_h).abs().max().item())
            what = (f"T={T} B={B} H={KERNEL_HIDDEN} W {str(dt)[6:]}, "
                    f"seq_lengths={'yes' if m is not None else 'no'}")
            if err > K3B_RTOL * scale:
                raise AssertionError(f"K3b disagrees with its plain loop ({what}): max |err| "
                                     f"{err:.3e} > {K3B_RTOL:.0e} x {scale:.3e}")
            worst = max(worst, err)
            _log(f"[11 train kernels] K3b ok {what}: max |err| {err:.3e} = "
                 f"{err / scale:.2e} of the largest |delta| (limit {K3B_RTOL:.0e})")
    return worst


def train_fixture_case(device, stored, name: str, mode: str) -> float:
    """The port's trainer from the fixture's weights on its batches: the
    losses against the JAX trainer's. Returns the max relative error."""
    key = f"{name}/{mode}/"
    cfg = zoo.get_config(name, table_scale=2000)
    np_params = bridge.init_numpy(cfg, int(stored[key + "seed"]))
    if not np.allclose(bridge.fingerprint(np_params), stored[key + "fingerprint"],
                       rtol=1e-9, atol=0):
        raise AssertionError(f"{key}: numpy drew other weights from the fixture's seed")
    tr = port_train.Trainer(cfg, optimizer="adagrad", learning_rate=float(stored[key + "lr"]),
                            sparse_tables=mode == "sparse", device=device,
                            params=bridge.params_from_numpy(np_params, cfg, device))
    indices = stored[key + "indices"]
    dense = stored[key + "dense"] if key + "dense" in stored.files else None
    gen = RecDataGenerator(tr.cfg, seed=1)
    losses = []
    for s in range(len(indices)):
        host = Batch(None if dense is None else dense[s], indices[s])
        if not np.array_equal(gen.generate_batch(indices.shape[1]).indices, indices[s]):
            raise AssertionError(f"{key}: the generator's batch {s} differs from the fixture's")
        losses.append(float(tr.step(host, tr._labels(host, None))))
    want = stored[key + "losses"]
    err = float(np.max(np.abs(np.asarray(losses) - want) / np.abs(want)))
    if not err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{key}: losses {losses} differ from JAX's {want.tolist()} "
                             f"(max relative error {err:.2e} > {TRAIN_LOSS_RTOL:.0e})")
    return err


def phase_train_fixture(device) -> float:
    stored = np.load(TRAIN_FIXTURE)
    worst = 0.0
    for name in TRAIN_FAMILIES:
        errs = {mode: train_fixture_case(device, stored, name, mode) for mode in ("dense", "sparse")}
        worst = max(worst, *errs.values())
        _log(f"[11 train fixture] {name} table_scale=2000 f32, 3 adagrad steps: losses match the "
             f"JAX trainer's, max relative error " + ", ".join(
                 f"{m} {e:.2e}" for m, e in errs.items()) + f" (limit {TRAIN_LOSS_RTOL:.0e})")
    return worst


def _train_want(name: str, sparse: bool, steps: int) -> dict:
    dien = zoo.get_config(name).model_type == "dien"
    return _want(embedding_bag=steps, embedding_bag_backward=0 if sparse else steps,
                 sparse_adagrad_step=steps if sparse else 0,
                 rnn_scan=2 * steps if dien else 0, rnn_scan_backward=2 * steps if dien else 0)


def train_path(device, name: str, sparse: bool, card: str) -> dict:
    """``train.main`` at full width (f32, batch TRAIN_BATCH, TRAIN_STEPS
    steps), the launches read around it: every step launches K1 once, K1b
    (dense) or K5 (sparse) once, and for dien K3 and K3b twice. The losses
    must be finite and fall (mean of the last four below the first four)."""
    args = ["--model", name, "--table_scale", str(TABLE_SCALE), "--steps", str(TRAIN_STEPS),
            "--batch_size", str(TRAIN_BATCH), "--device", str(device)]
    args += ["--sparse_tables"] if sparse else []
    _reset_peak(device)
    _reset_counts()
    t0 = time.perf_counter()
    losses = port_train.main(args)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = _counts()
    what = f"{name} {'--sparse_tables' if sparse else 'dense'}"
    if counts != _train_want(name, sparse, len(losses)):
        raise AssertionError(f"train {what}: launches {counts} for {len(losses)} steps")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"train {what}: losses not finite and falling: {losses}")
    peak = _peak_gib(device)
    _log(f"[11 train] python -m deeprecsys_tpu_torch.train {' '.join(args)}: {len(losses)} steps, "
         f"loss {first:.4f} -> {last:.4f}, launches {counts}, {wall:.2f} s with init, peak "
         f"device memory {peak:.3f} GiB [{card}]")
    _free(device)
    return {"losses": losses, "launches": counts, "wall_s": wall, "peak_gib": peak}


def round_trip(device, card: str) -> dict:
    """Train rm1 at ROUND_TRIP_SCALE, save and export (int8_rowwise) it,
    then serve the float checkpoint through main.py --checkpoint:
    standalone (its scores are the checkpoint's params' scores, not a
    random init's) and --queue (DIEN_QUERIES queries, no errors)."""
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "rm1_trained"
    launches = _want()
    _reset_counts()
    losses = port_train.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE),
                              "--steps", "20", "--batch_size", str(TRAIN_BATCH), "--device",
                              str(device), "--save", str(ckpt), "--export_quant", "int8_rowwise"])
    _add(launches, _counts())
    cfg = zoo.get_config("rm1", table_scale=ROUND_TRIP_SCALE)
    bundle = load_model_params(cfg.replace(table_quant="int8_rowwise"), f"{ckpt}_int8_rowwise")
    qrows = bundle["tables"]["qrows"]
    if qrows.shape != (cfg.total_rows, cfg.sparse_feature_size + 4) or qrows.dtype != np.int8:
        raise AssertionError(f"export bundle: qrows {qrows.shape} {qrows.dtype}")
    params = checkpoint_params(cfg, ckpt, device)
    _reset_counts()
    res = port_main.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE),
                          "--checkpoint", str(ckpt), "--device", str(device),
                          "--num_batches", "4", "--mini_batch_size", str(BATCH)])
    counts = _counts()
    if counts != _want(embedding_bag=res["forwards"]):
        raise AssertionError(f"main.py --checkpoint: launches {counts}")
    _add(launches, counts)
    model = get_model(cfg, device)
    batches = RecDataGenerator(cfg, seed=123).generate_batches(4, BATCH)
    with torch.inference_mode():
        worst = max((out.float() - model.apply(params, b.to(device)).float()).abs().max().item()
                    for out, b in zip(res["outputs"], batches))
        random_init = model.apply(model.init(torch.Generator(device=device).manual_seed(123)),
                                  batches[0].to(device))
    if worst != 0.0 or torch.equal(random_init, res["outputs"][0]):
        raise AssertionError(f"main.py --checkpoint did not score the checkpoint's params "
                             f"(max |err| {worst:.3e})")
    _log(f"[11 round trip] rm1 table_scale={ROUND_TRIP_SCALE}: train {len(losses)} steps, "
         f"loss {np.mean(losses[:4]):.4f} -> {np.mean(losses[-4:]):.4f}; --save and "
         f"--export_quant int8_rowwise (qrows {qrows.shape}) load against the configs; "
         f"main.py --checkpoint standalone scores the checkpoint's params exactly "
         f"({res['forwards']} forwards)")
    _reset_counts()
    res_q = port_main.main([
        "--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE), "--checkpoint", str(ckpt),
        "--queue", "--engine_backend", _backend(device), "--num_batches", str(DIEN_QUERIES),
        "--batch_size_distribution", "normal", "--avg_mini_batch_size", "165",
        "--var_mini_batch_size", "16", "--sub_task_batch_size", "32",
        "--avg_arrival_rate", "10"])
    counts = _counts()
    _check_served(res_q, counts, 0, "rm1 checkpoint served by main.py --queue")
    _add(launches, counts)
    _log(f"[11 round trip] main.py --checkpoint --queue: {_served_line(res_q, counts)} [{card}]")
    for p in out_dir.glob("rm1_trained*"):
        p.unlink()
    return {"launches": launches, "queue": res_q.to_dict()}


def _g_rows(g, offsets, indices):
    """The pooled gradient broadcast over the L slots (f32), its rows' mean
    squares and their fused rows: the library yardsticks' inputs."""
    B, T, L = indices.shape
    rows = g.float()[:, :, None, :].expand(B, T, L, g.shape[-1]).reshape(B * T * L, -1)
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    return rows.contiguous(), torch.mean(rows * rows, dim=-1), flat


def _timed(runs: dict, kernel_field: str = "kernel_ms") -> dict:
    """A kernel's times from runs in the order plain, kernel, kernel, plain
    and a library run: device times where the trace has them, else wall."""
    k_dev = _mean(runs, ("k1", "k2"), kernel_field)
    p_dev = _mean(runs, ("p1", "p2"), "device_ms")
    use_dev = None not in (k_dev, p_dev, runs["s1"]["device_ms"])
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    return {"ms": k_dev if use_dev else k_wall, "plain_ms": p_dev if use_dev else p_wall,
            "library_ms": runs["s1"]["device_ms" if use_dev else "wall_ms"],
            "device": use_dev, "k_wall": k_wall, "p_wall": p_wall}


def _time_runs(kernel, plain, library, args, lib_args, iters) -> dict:
    runs = {key: measure(fn, args, iters) for key, fn in
            (("p1", plain), ("k1", kernel), ("k2", kernel), ("p2", plain))}
    runs["s1"] = measure(library, lib_args, iters)
    return runs


def train_kernel_times(device, card: str) -> dict:
    """K1b and K5 at rm1's training shape (full-size f32 table, batch
    TRAIN_BATCH, eight batches of ids), K3b at dien's (T = 40, B =
    TRAIN_BATCH): each kernel beside its plain version (order plain,
    kernel, kernel, plain), its bound and its library yardstick. K1b and
    its yardsticks accumulate into one preallocated f32 gradient (the
    zero-fill of a step is the same for all, and shows in the step's
    breakdown)."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    offsets = table_offsets(cfg, device)
    gen = torch.Generator(device=device).manual_seed(5)
    ids = [b.to(device).indices for b in
           RecDataGenerator(cfg, seed=3).generate_batches(8, TRAIN_BATCH)]
    gs = [torch.randn((TRAIN_BATCH, cfg.num_tables, d), generator=gen, device=device) * 1e-2
          for _ in ids]
    prepared = [_g_rows(g, offsets, i) for g, i in zip(gs, ids)]
    out = {}
    grad = torch.zeros((R, d), dtype=torch.float32, device=device)
    runs = _time_runs(
        lambda g, i: embedding_bag_backward(g, offsets, i, R, out=grad),
        lambda g, i: embedding_bag_backward_reference(g, offsets, i, R, out=grad),
        k1b_library(grad), list(zip(gs, ids)), [(p[0], p[2]) for p in prepared], TIMED_ITERS)
    out["embedding_bag_backward"] = {**_timed(runs), **k1b_bound(gs[0], offsets, ids[0])}
    del grad
    _free(device)
    table = (torch.rand((R, d), generator=gen, device=device) - 0.5) * 0.1
    acc = torch.zeros((R,), dtype=torch.float32, device=device)
    runs.update(_time_runs(
        lambda g, i: sparse_adagrad_step(table, acc, offsets, i, g, 0.1),
        lambda g, i: sparse_adagrad_step_reference(table, acc, offsets, i, g, 0.1),
        k5_library(table, acc, 0.1), list(zip(gs, ids)), prepared, TIMED_ITERS))
    out["sparse_adagrad_step"] = {**_timed(runs, "device_ms"),
                                  **k5_bound(table, gs[0], offsets, ids[0])}
    del table, acc, prepared
    _free(device)
    y, gh, w, _ = _rnn_backward_inputs(device, DIEN_T, TRAIN_BATCH, torch.float32, seed=6)
    inp = rnn_inputs(device, DIEN_T, TRAIN_BATCH, torch.float32, seed=6)
    runs = _time_runs(rnn_scan_backward, rnn_scan_backward_reference,
                      k3b_library(w, inp["h2h_b"], inp["xproj"]), [(y, gh, w)], [(gh,)], 50)
    out["rnn_scan_backward"] = {**_timed(runs), **k3b_bound(DIEN_T, TRAIN_BATCH, KERNEL_HIDDEN)}
    shapes = {"embedding_bag_backward": f"rm1 B={TRAIN_BATCH} T=8 L=80 d=32 f32, R={R}",
              "sparse_adagrad_step": f"rm1 B={TRAIN_BATCH} T=8 L=80 d=32 f32 table, R={R}",
              "rnn_scan_backward": f"dien T={DIEN_T} B={TRAIN_BATCH} H={KERNEL_HIDDEN} f32"}
    names = {"embedding_bag_backward": ("K1b", "index_add_"),
             "sparse_adagrad_step": ("K5 (both launches)", "index_add_ sequence"),
             "rnn_scan_backward": ("K3b", "cuDNN RNN backward-data")}
    for key, t in out.items():
        label, lib = names[key]
        _log(f"[11 train times] {label} at {shapes[key]}: {t['ms'] * 1e3:.2f} us "
             f"({'device' if t['device'] else 'wall'}); bound {t['bound_ms'] * 1e3:.2f} us "
             f"({t['bound_by']}, {t['bytes'] / 1e6:.2f} MB); plain {t['plain_ms'] * 1e3:.2f} us; "
             f"{lib} {t['library_ms'] * 1e3:.2f} us; wall a call {t['k_wall'] * 1e3:.2f} us "
             f"[{card}]")
    return out


def train_step_times(device, name: str, sparse: bool, card: str) -> dict:
    """One training step of the CLI's (host batch to the card, forward,
    backward, update, the loss read back) at full width: wall and device
    time a step, idle share, the kernels that took the most device time,
    and peak device memory (trainer state included)."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
    _reset_peak(device)
    tr = port_train.Trainer(cfg, learning_rate=0.1, sparse_tables=sparse, device=device)
    gen = RecDataGenerator(tr.cfg, seed=1)
    hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(4)]
    args = [(h, tr._labels(h, None)) for h in hosts]
    m = measure(lambda h, lab: float(tr.step(h, lab)), args, 20)
    peak = _peak_gib(device)
    dev = m["device_ms"]
    idle = None if dev is None else 1 - dev / m["wall_ms"]
    what = f"{name} {'--sparse_tables' if sparse else 'dense'}"
    _log(f"[11 train steps] {what} batch {TRAIN_BATCH} f32: wall {m['wall_ms']:.4f} ms a step, "
         f"device {_us(dev)} in {m['launches']:.0f} device ops, idle "
         f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; peak device memory "
         f"{peak:.3f} GiB [{card}]")
    _log(f"[11 train steps] {what}, device time by kernel: {_top(m, 8)} [{card}]")
    if not sparse:
        # The two passes over the whole table that the step's kernels share
        # one name with: the gradient's zero-fill and the optimizer's sweep.
        R, d = tr.params["tables"].shape
        fill = measure(lambda: torch.zeros((R, d), device=device), [()], 5)
        leaves = port_train._leaves(tr.params)
        grads = [torch.zeros_like(p) for p in leaves]
        sweep = measure(lambda: tr.tx.update(leaves, grads, tr.opt_state), [()], 5)
        _log(f"[11 train steps] {what} breakdown: the (R, d) gradient's zero-fill "
             f"{_us(fill['device_ms'])} (wall {fill['wall_ms'] * 1e3:.2f} us), adagrad's sweep "
             f"over every param {_us(sweep['device_ms'])} in {sweep['launches']:.0f} device ops "
             f"(wall {sweep['wall_ms'] * 1e3:.2f} us) [{card}]")
        del grads
    del tr
    _free(device)
    return {"name": what, "wall_ms": m["wall_ms"], "device_ms": dev, "idle": idle,
            "peak_gib": peak}


def phase_train(device, card: str) -> tuple[dict, dict, list]:
    """Phase 11: the trainer. Returns the kernels' errors and times, the
    launches of the training paths and the step times."""
    t0 = time.perf_counter()
    errs = {}
    for seed, name in enumerate(("rm1", "dien")):
        for k, v in train_kernel_cases(device, name, seed).items():
            errs[k] = max(errs.get(k, 0.0), v)
    errs["rnn_scan_backward"] = max(train_rnn_cases(device, DIEN_T, TRAIN_BATCH),
                                    train_rnn_cases(device, DIEN_T, BATCH, seed=1))
    phase_train_fixture(device)
    launches = _want()
    for name, sparse in (("rm1", False), ("rm1", True), ("dien", True)):
        _add(launches, train_path(device, name, sparse, card)["launches"])
    _add(launches, round_trip(device, card)["launches"])
    times = train_kernel_times(device, card)
    steps = [train_step_times(device, name, sparse, card)
             for name, sparse in (("rm1", False), ("rm1", True), ("dien", True))]
    _log(f"[11 train] phase 11 in {time.perf_counter() - t0:.1f} s")
    return {k: {**times[k], "max_abs_err": errs[k]} for k in times}, launches, steps


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
    _add(launches, serve_launches)
    torch.cuda.reset_peak_memory_stats(device)
    times = phase_times(device, fwd, card["card"])
    del fwd
    torch.cuda.empty_cache()

    # The other models' paths, each read around itself.
    rows, zoo_launches = phase_zoo(device, card["card"])
    _add(launches, zoo_launches)
    if launches["rnn_scan"] == 0:
        raise AssertionError("dien's path never launched K3")
    k3 = phase_rnn_times(device, card["card"])

    # The trainer's paths, each read around itself.
    trained, train_launches, steps = phase_train(device, card["card"])
    _add(launches, train_launches)
    for key in ("embedding_bag_backward", "sparse_adagrad_step", "rnn_scan_backward"):
        if launches[key] == 0:
            raise AssertionError(f"the training paths never launched {key}")

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
    _log("[10 summary] training step, f32, batch 128, full-size tables: wall ms, device ms, "
         "idle, peak GiB")
    for st in steps:
        dev = "not measured" if st["device_ms"] is None else f"{st['device_ms']:.4f}"
        idle = "not measured" if st["idle"] is None else f"{100 * st['idle']:.1f}%"
        _log(f"[10 summary]   {st['name']}: {st['wall_ms']:.4f}, {dev}, {idle}, "
             f"{st['peak_gib']:.3f} [{card['card']}]")
    _log(f"[10 summary] chip_smoke took {time.perf_counter() - t_start:.1f} s after start-up")

    print(card_line())
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "embedding_bag", "route": "cuda", **KERNELS["embedding_bag"],
         "launches": launches["embedding_bag"], "max_abs_err": k1_err,
         **{k: times["k1"][k] for k in timed}},
        {"name": "rnn_scan", "route": "cuda", **KERNELS["rnn_scan"],
         "launches": launches["rnn_scan"], "max_abs_err": k3_err,
         **{k: k3[k] for k in timed}}] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": trained[key]["max_abs_err"], **{k: trained[key][k] for k in timed}}
        for key in ("embedding_bag_backward", "sparse_adagrad_step", "rnn_scan_backward")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
