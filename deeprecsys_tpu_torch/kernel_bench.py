"""K1 and K3 on one card: their times beside their bounds and a library
yardstick, and each wrapper's host time a call. The bounds and library
yardsticks of the training kernels K1b, K5 and K3b (``k1b_bound``,
``k5_library``, ...) live here too; ``chip_smoke.py`` times those.

    python -m deeprecsys_tpu_torch.kernel_bench [--json PATH]

For K1 at every zoo model's shape (bf16, batch 512, full-size tables, ids
from the port's generator, 8 batches so that rows come cold from device
memory), and for K3 at DIEN's shape (T = 40, B = 512, H = 64, bf16), it
checks each kernel against its plain version and prints, and writes to
PATH:

- device time a call, from a ``torch.profiler`` trace;
- ``bound_ms``: the larger of the bytes the call must move over 3.35 TB/s
  and its operations over the card's f32 rate (67 TFLOP/s), both the
  published H100 SXM figures at 700 W (``k1_bound``, ``k3_bound``);
- ``library_ms``: one PyTorch call computing the same function,
  ``F.embedding_bag(mode="sum")`` for K1, cuDNN's tanh RNN for K3;
- each wrapper's host time a call, the mean over back-to-back calls that
  the card keeps up with (rm1's shape and a 32-row sub-batch of dien).

It times the port of the checkout it runs in and calls only the port's
public functions. To compare two versions of the kernels, unpack the other
version's tree (``git archive <commit>``) into a directory that
``.gitignore`` lists, copy this file into its ``deeprecsys_tpu_torch/``,
and run it there and here in turns (other, this, this, other) in one call
on the card.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, 700 W
F32_FLOP_PER_S = 67e12     # H100 SXM f32 outside the tensor cores, same source
BATCH = 512
DIEN_T = 40


def measure(fn, args_list, iters: int = 100) -> dict:
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
    # For a call of one kernel: the median kernel, which a dropped trace event
    # cannot pull down as it can the sum.
    kernel_ms = float(np.median([e.time_range.elapsed_us() for e in dev])) / 1e3 if dev else None
    by_name: dict = {}
    for e in dev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / iters
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernel_ms": kernel_ms,
            "launches": len(dev) / iters,
            "kernels": sorted(by_name), "us_by_kernel": by_name}


def host_us(fn, args, iters: int = 200) -> float:
    """Host time a call, in µs: ``iters`` back-to-back calls timed on the
    host clock before the closing synchronize."""
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _bound(nbytes: float, flops: float) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _touched_rows(offsets: torch.Tensor, indices: torch.Tensor) -> int:
    """The distinct fused rows a batch reads."""
    return torch.unique(indices.long() + offsets.long()[None, :, None]).numel()


def k1_bound(table: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
             out_dtype: torch.dtype) -> dict:
    """K1's least time on these inputs: each distinct row of the batch read
    once, the ids read and the output written once; one f32 add a gathered
    element."""
    B, T, L = indices.shape
    d = table.shape[1]
    nbytes = (_touched_rows(offsets, indices) * d * table.element_size() + indices.numel() * 4
              + B * T * d * torch.empty((), dtype=out_dtype).element_size())
    return _bound(nbytes, B * T * L * d)


def k3_bound(T: int, B: int, H: int, out_dtype: torch.dtype) -> dict:
    """K3's least time: xproj (f32) read and all_h written once, W and the
    bias read once; a multiply and an add for each of T * B * H * H terms."""
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = T * B * H * (4 + out_size) + (H * H + H) * 4
    return _bound(nbytes, 2 * T * B * H * H)


def k1b_bound(g: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor) -> dict:
    """K1b's least time on these inputs, accumulating into an existing
    gradient buffer: each touched f32 row read and written once, ``g`` and
    the ids read once; one add a gathered element."""
    B, T, L = indices.shape
    d = g.shape[-1]
    nbytes = (_touched_rows(offsets, indices) * d * 4 * 2 + g.numel() * g.element_size()
              + indices.numel() * 4)
    return _bound(nbytes, B * T * L * d)


def k5_bound(table: torch.Tensor, g: torch.Tensor, offsets: torch.Tensor,
             indices: torch.Tensor) -> dict:
    """K5's least time: each touched table row and accumulator read and
    written once, ``g`` and the ids read once; a bag's mean g^2 (2 d
    operations) and, a slot, its accumulator add and a multiply, a multiply
    and an add an element."""
    B, T, L = indices.shape
    d = g.shape[-1]
    nbytes = (_touched_rows(offsets, indices) * (d * table.element_size() + 4) * 2
              + g.numel() * g.element_size() + indices.numel() * 4)
    return _bound(nbytes, B * T * 2 * d + B * T * L * (3 * d + 2))


def k3b_bound(T: int, B: int, H: int) -> dict:
    """K3b's least time: y and the state gradients (f32) read and delta
    written once, W read once, dh0 written once; the reverse dot (a
    multiply and an add for each of T * B * H * H terms) and 4 operations
    an element for the tanh VJP."""
    nbytes = 3 * T * B * H * 4 + H * H * 4 + B * H * 4
    return _bound(nbytes, 2 * T * B * H * H + 4 * T * B * H)


def k1b_library(out: torch.Tensor):
    """K1b's scatter as one PyTorch call: ``Tensor.index_add_`` into ``out``
    of the gradient rows ``(B*T*L, d)`` f32 (the pooled gradient broadcast
    over the L slots beforehand) at the fused rows ``flat``."""
    def call(g_rows, flat):
        return out.index_add_(0, flat, g_rows)
    return call


def k5_library(table: torch.Tensor, acc: torch.Tensor, learning_rate: float,
               eps: float = 1e-8):
    """K5's scatters as PyTorch calls on gradient rows broadcast beforehand
    (and their mean squares): the accumulator's ``index_add_``, its gather
    and the table's ``index_add_``."""
    def call(g_rows, row_g2, flat):
        acc.index_add_(0, flat, row_g2)
        scale = torch.rsqrt(acc[flat] + eps)
        return table.index_add_(0, flat, (-learning_rate * (g_rows * scale[:, None])).to(
            table.dtype))
    return call


def k3b_library(h2h_w: torch.Tensor, h2h_b: torch.Tensor, xproj: torch.Tensor):
    """cuDNN's backward of the tanh RNN of ``k3_library`` (W_ih = I) run on
    ``xproj``: the gradient of its input for a given gradient of its
    outputs, the work of K3b (cuDNN's backward-data pass; no weight
    gradients are asked for)."""
    rnn_call = k3_library(h2h_w, h2h_b)
    x = xproj.to(h2h_w.dtype).detach().requires_grad_(True)
    with torch.enable_grad():
        out, _ = rnn_call(x)

    def call(g_out):
        with torch.enable_grad():
            return torch.autograd.grad(out, [x], g_out, retain_graph=True)
    return call


def k1_library(table: torch.Tensor, offsets: torch.Tensor):
    """``F.embedding_bag(mode="sum")`` over the fused flat ids: the same
    pooled sums in the table's dtype (its summation order differs)."""
    def call(indices):
        B, T, L = indices.shape
        flat = (indices.long() + offsets.long()[None, :, None]).view(B * T, L)
        return torch.nn.functional.embedding_bag(flat, table, mode="sum")
    return call


def k3_library(h2h_w: torch.Tensor, h2h_b: torch.Tensor):
    """cuDNN's tanh RNN (``torch.nn.RNN``) with W_ih = I and b_ih = 0, so it
    computes h_t = tanh(xproj_t + h_{t-1} @ W + b) over xproj in the
    weights' dtype. It also runs the input product with the identity: one
    extra (T * B, H) x (H, H) GEMM."""
    H = h2h_w.shape[0]
    rnn = torch.nn.RNN(H, H, nonlinearity="tanh").to(device=h2h_w.device, dtype=h2h_w.dtype)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(H))
        rnn.bias_ih_l0.zero_()
        rnn.weight_hh_l0.copy_(h2h_w.t())
        rnn.bias_hh_l0.copy_(h2h_b)
    rnn.flatten_parameters()

    def call(xproj):
        return rnn(xproj)
    return call


def ptxas_summary(log: str) -> list:
    """``"<kernel template arguments>: <registers>, <spills>"`` for every
    kernel instance in an ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?kernelI(\w+?)E[EvP]", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spilled")
            name = None
    return out


def bench_k1(log) -> list:
    """K1 at every zoo shape: device time, bound, library call."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops.embedding import (
        embedding_bag, embedding_bag_reference, pooled_tolerance)

    device = torch.device("cuda")
    rows = []
    for name in zoo.MODEL_NAMES:
        cfg = zoo.get_config(name)
        g = torch.Generator(device=device).manual_seed(0)
        table = torch.empty((cfg.total_rows, cfg.sparse_feature_size), dtype=torch.bfloat16,
                            device=device).uniform_(-0.05, 0.05, generator=g)
        offsets = table_offsets(cfg, device)
        batches = [b.to(device).indices
                   for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
        got = embedding_bag(table, offsets, batches[0])
        want = embedding_bag_reference(table, offsets, batches[0])
        tol = pooled_tolerance(got, want, table, offsets, batches[0])
        if not bool(((got.float() - want.float()).abs() <= tol).all()):
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        ids = [(i,) for i in batches]
        run = measure(lambda i: embedding_bag(table, offsets, i), ids)
        library = measure(k1_library(table, offsets), ids)
        row = {"model": name, "shape": list(batches[0].shape) + [cfg.sparse_feature_size],
               **k1_bound(table, offsets, batches[0], torch.bfloat16),
               "ms": run["device_ms"], "wall_ms": run["wall_ms"],
               "library_ms": library["device_ms"], "library_wall_ms": library["wall_ms"]}
        log(f"K1 {name} {row['shape']}: {_us(row['ms'])}; bound {_us(row['bound_ms'])} "
            f"({row['bound_by']}); F.embedding_bag {_us(row['library_ms'])}")
        rows.append(row)
        del table, batches, got, want
        torch.cuda.empty_cache()
    return rows


def bench_k1_host(log) -> dict:
    """Host time a K1 call at rm1's shape and at a 32-row sub-batch of dien
    (where the card finishes each call long before the host issues the
    next), two runs each."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops.embedding import embedding_bag

    device = torch.device("cuda")
    out = {}
    for name, B in (("rm1", BATCH), ("dien", 32)):
        cfg = zoo.get_config(name, table_scale=100)
        table = torch.zeros((cfg.total_rows, cfg.sparse_feature_size), dtype=torch.bfloat16,
                            device=device)
        offsets = table_offsets(cfg, device)
        idx = RecDataGenerator(cfg, seed=4).generate_batch(B).to(device).indices
        out[name] = [host_us(embedding_bag, (table, offsets, idx)) for _ in range(2)]
        log(f"K1 host time a call at {name}'s shape, B={B}: "
            + " / ".join(f"{t:.2f}" for t in out[name]) + " us")
    return out


def bench_k3(log) -> dict:
    """K3 at DIEN's shape, bf16: device time, bound, library call, and the
    wrapper's host time a call at a 32-row batch."""
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan, rnn_scan_reference

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(1)
    H, dt = 64, torch.bfloat16
    xproj = torch.randn((DIEN_T, BATCH, H), generator=g, device=device)
    w = (torch.randn((H, H), generator=g, device=device) / H ** 0.5).to(dt)
    b = (torch.randn((H,), generator=g, device=device) * 0.1).to(dt)
    want, _ = rnn_scan_reference(xproj, w, b, dt)
    got, _ = rnn_scan(xproj, w, b, dt)
    err = (got.float() - want.float()).abs().max().item()
    if err > 2.0 ** -7:
        raise AssertionError(f"K3 disagrees with its plain loop: {err:.3e}")
    run = measure(rnn_scan, [(xproj, w, b, dt)], 50)
    library = measure(k3_library(w, b), [(xproj.to(dt),)], 50)
    small = (xproj[:, :32].contiguous(), w, b, dt)
    host = [host_us(rnn_scan, small) for _ in range(2)]
    row = {"shape": [DIEN_T, BATCH, H], **k3_bound(DIEN_T, BATCH, H, dt),
           "ms": run["device_ms"], "wall_ms": run["wall_ms"], "max_abs_err": err,
           "library_ms": library["device_ms"], "library_wall_ms": library["wall_ms"],
           "library_kernels": library["kernels"], "host_us": host}
    log(f"K3 {row['shape']}: {_us(row['ms'])}; bound {_us(row['bound_ms'])} "
        f"({row['bound_by']}); cuDNN RNN {_us(row['library_ms'])} in "
        f"{library['launches']:.0f} device ops; max |err| vs the plain loop {err:.3e}; "
        "host time a call at B=32: " + " / ".join(f"{t:.2f}" for t in host) + " us")
    return row


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(f"[kernel_bench] {msg}", flush=True)

    from deeprecsys_tpu_torch.ops import _build

    card = card_line()
    log(f"card: {card}; port at {Path(_build.__file__).parents[2]}")
    for key in ("embedding_bag", "rnn_scan"):
        log(f"{key}: ptxas " + "; ".join(ptxas_summary(_build.build(key).log)))
    with torch.inference_mode():
        res = {"card": card, "k1": bench_k1(log), "k1_host_us": bench_k1_host(log),
               "k3": bench_k3(log)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
