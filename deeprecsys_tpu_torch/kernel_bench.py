"""K1, K3, the int8 lookups K1-int8 and K4, the hot/cold lookup K6 and
the RNN's reverse scan K3b on one card: their times beside their bounds and
a library yardstick, and each wrapper's host time a call. The bounds and
library yardsticks of the other training kernels K1b and K5 (``k1b_bound``,
``k5_library``, ...) live here too; ``chip_smoke.py`` times those.

    python -m deeprecsys_tpu_torch.kernel_bench [--json PATH] [--only k1,k1_host,k3,int8,k6,k3b]

For K1, K1-int8 and K4 at every zoo model's shape (bf16 output, batch 512,
full-size tables, ids from the port's generator, 8 batches so that rows
come cold from device memory; K1-int8 and K4 also on zipf(1.2) ids), and
for K3 at DIEN's shape (T = 40, B = 512, H = 64, bf16), it checks each
kernel against its plain version and prints, and writes to PATH:

- device time a call, from a ``torch.profiler`` trace;
- ``bound_ms``: the larger of the bytes the call must move over 3.35 TB/s
  and its operations over the card's f32 rate (67 TFLOP/s), both the
  published H100 SXM figures at 700 W (``k1_bound``, ``k3_bound``);
- ``library_ms``: one PyTorch call computing the same function,
  ``F.embedding_bag(mode="sum")`` for K1, cuDNN's tanh RNN for K3; none
  for K1-int8 and K4 (no PyTorch call pools int8 rows), which are printed
  beside K1's time on the same ids over a bf16 table instead, with their
  rows/s and the registers and spills of the instance each launches;
- each wrapper's host time a call, the mean over back-to-back calls that
  the card keeps up with (rm1's shape and a 32-row sub-batch of dien).

For K6 (``bench_k6``) at every zoo model's shape on zipf(1.2) ids with the
JAX package's hot-set rule, in the three table layouts: its time, the sum of its two launches
(``cold_start``, then the pool), each launch's, the wall time and the host
time a call (K6's wrapper and the direct one's, each the median of 21
runs), and ``k6_bound`` beside the direct kernel of the layout on the same
ids (K1, K1-int8, K4) and, for float tables, ``F.embedding_bag`` on the
original ids, which computes the same pooled sums; the ``cold_start``
launch's time beside its own bound (``cold_starts_bound``).

For K3b (``bench_k3b``) at T = 40 and B = 128 (the trainer's batch) and
512, with f32 and bf16 weights: it checks the kernel against its plain
loop with and without ``seq_lengths``, then gives the kernel's median
device time beside ``k3b_bound``, cuDNN's backward-data pass
(``k3b_library``), the plain loop and the wrapper's host time a call.

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


def wall_ms(fn, args_list, iters: int, cuda: bool = True) -> float:
    """ms a call of ``iters`` back-to-back calls of ``fn`` cycling through
    ``args_list``: CUDA events around the loop, so host launch cost shows
    wherever it leaves the card idle; with ``cuda=False``, the host clock
    around it (CPU ops return when done)."""
    if not cuda:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(fn, args_list, iters: int = 100, traces: int = 3) -> dict:
    """Per-call times of ``iters`` back-to-back calls cycling through
    ``args_list``, after a warm-up. ``wall_ms``: the function of that name
    over the loop. ``device_ms``:
    the summed durations of the device kernels and copies the calls ran,
    from a torch.profiler trace of a second loop, traced again (up to
    ``traces`` times) when a trace comes back without device activity
    (None if every one did)."""
    for a in args_list:
        fn(*a)
    wall = wall_ms(fn, args_list, iters)
    for _ in range(traces):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / iters if dev else None
    durations: dict = {}
    for e in dev:
        durations.setdefault(e.name[:60], []).append(e.time_range.elapsed_us())
    by_name = {name: sum(us) / iters for name, us in durations.items()}
    return {"wall_ms": wall, "device_ms": device_ms,
            "kernel_ms": main_kernel_ms(durations) if dev else None,
            "launch_sum_ms": launch_sum_ms(durations, iters) if dev else None,
            "median_ms_by_kernel": {name: float(np.median(us)) / 1e3
                                    for name, us in durations.items()},
            "launches": len(dev) / iters,
            "kernels": sorted(by_name), "us_by_kernel": by_name}


def main_kernel_ms(durations: dict) -> float:
    """The median duration (ms) of the kernel that took the most device
    time, from ``{name: [µs of each event]}``: a call's kernel time, which a
    dropped trace event cannot pull down as it can the sum, and which a
    small op the call also runs (a zero-fill) does not pull to a midpoint
    as the median over all events did."""
    name = max(durations, key=lambda n: sum(durations[n]))
    return float(np.median(durations[name])) / 1e3


def named_kernel_ms(run: dict, part: str):
    """The median duration (ms) of the kernel of ``measure``'s ``run`` whose
    name holds ``part``, or None if no kernel's does."""
    return next((ms for name, ms in run["median_ms_by_kernel"].items() if part in name), None)


def span_ms(fn, args_list, iters: int = 50, spin_cycles: int = 200_000) -> float:
    """Device time a call, from the card reaching the call to its last
    launch's end (launches that overlap count once, the gaps between them
    do count): each call queued behind a spin kernel (``torch.cuda._sleep``,
    ~0.1 ms) so that the host has queued it before the card gets to it, and
    timed by CUDA events on either side; the median over ``iters`` calls
    cycling through ``args_list``."""
    for a in args_list:
        fn(*a)
    pairs = []
    for i in range(iters):
        torch.cuda._sleep(spin_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args_list[i % len(args_list)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def launch_sum_ms(durations: dict, iters: int) -> float:
    """A call's device time over all of its launches (K6's two, K5's two):
    each kernel's median duration (ms) times its launches a call, summed
    over kernels, from ``{name: [µs of each event]}`` of ``iters`` calls;
    as ``main_kernel_ms``, a dropped trace event cannot pull it down."""
    return sum(float(np.median(us)) * max(1, round(len(us) / iters))
               for us in durations.values()) / 1e3


def host_us(fn, args, iters: int = 200, reps: int = 1) -> float:
    """Host time a call, in µs: ``iters`` back-to-back calls timed on the
    host clock before the closing synchronize; the median of ``reps`` such
    runs."""
    runs = []
    for _ in range(reps):
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        runs.append((t1 - t0) / iters * 1e6)
    return float(np.median(runs))


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


def k1_int8_bound(q: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
                  out_dtype: torch.dtype) -> dict:
    """K1-int8's least time on these inputs: K1's accounting at 1-byte
    elements (each distinct d-byte row once, the ids, the (T,) f32 scales,
    the output); an int add a gathered element and a multiply an output
    element, at the f32 rate."""
    B, T, L = indices.shape
    d = q.shape[1]
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (_touched_rows(offsets, indices) * d + indices.numel() * 4 + T * 4
              + B * T * d * out_size)
    return _bound(nbytes, B * T * L * d + B * T * d)


def k4_bound(qrows: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
             out_dtype: torch.dtype) -> dict:
    """K4's least time on these inputs: each distinct (d + 4)-byte row
    once, the ids, the output; a multiply and an add a gathered element."""
    B, T, L = indices.shape
    d = qrows.shape[1] - 4
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (_touched_rows(offsets, indices) * (d + 4) + indices.numel() * 4
              + B * T * d * out_size)
    return _bound(nbytes, 2 * B * T * L * d)


def window_bound(shard: torch.Tensor, row_lo: int, offsets: torch.Tensor,
                 indices: torch.Tensor, d: int, ops_per_element: int = 1) -> dict:
    """A row shard's lookup (K1, K1-int8 or K4 with the ownership window):
    each distinct row of the batch that the shard owns read once (the
    shard's row bytes each), every id read once (the kernel tests each
    against the window), the ``(B, T, d)`` 4-byte partial (f32 or int32)
    written once; ``ops_per_element`` operations a gathered element of an
    owned slot."""
    B, T, L = indices.shape
    flat = indices.long() + offsets.long()[None, :, None]
    owned = (flat >= row_lo) & (flat < row_lo + shard.shape[0])
    rows = torch.unique(flat[owned]).numel()
    row_bytes = shard.shape[1] * shard.element_size()
    nbytes = rows * row_bytes + indices.numel() * 4 + B * T * d * 4
    return _bound(nbytes, int(owned.sum()) * d * ops_per_element)


def window_library(shard: torch.Tensor, row_lo: int, offsets: torch.Tensor):
    """``F.embedding_bag(mode="sum")`` over a float shard with the window as
    ``per_sample_weights`` (1 for an owned slot, 0 else; the local ids
    clamped): the same partial sums in the shard's dtype."""
    def call(indices):
        B, T, L = indices.shape
        flat = (indices.long() + offsets.long()[None, :, None]).view(B * T, L) - row_lo
        owned = (flat >= 0) & (flat < shard.shape[0])
        return torch.nn.functional.embedding_bag(torch.where(owned, flat, 0), shard, mode="sum",
                                                 per_sample_weights=owned.to(shard.dtype))
    return call


def k6_bound(hot: torch.Tensor, table: torch.Tensor, split: dict, out_dtype: torch.dtype,
             mode: str = "float") -> dict:
    """K6's least time on these inputs, by the bytes the function must move:
    each distinct hot row and each distinct cold row the split touches read
    once (row bytes of the table's layout), ``hot_sel`` and ``hot_mask`` (5
    bytes a slot), ``cold_ids`` and ``cold_seg`` (8 bytes a padded cold
    slot), the per-table scales (int8) and the output; an add a gathered
    element, plus a multiply an element for row-wise rows and a multiply an
    output element for per-table int8. ``cold_start``, the scratch of K6's
    design, is not the function's: ``cold_starts_bound`` bounds the launch
    that writes it. ``mode``: "float", "int8" or "int8_rowwise"."""
    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    cold_ids, cold_seg = split["cold_ids"], split["cold_seg"]
    B, T, L = hot_sel.shape
    d = table.shape[1] - (4 if mode == "int8_rowwise" else 0)
    row_bytes = table.shape[1] * table.element_size()
    real = cold_seg < B * T
    rows = (torch.unique(hot_sel[hot_mask]).numel()
            + torch.unique(cold_ids[real]).numel())
    gathered = int(hot_mask.sum()) + int(real.sum())
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (rows * row_bytes + B * T * L * 5 + cold_ids.numel() * 8 + B * T * d * out_size
              + (T * 4 if mode == "int8" else 0))
    flops = gathered * d * (2 if mode == "int8_rowwise" else 1) + (
        B * T * d if mode == "int8" else 0)
    return _bound(nbytes, flops)


def cold_starts_bound(split: dict) -> dict:
    """The least time of K6's first launch alone: ``cold_seg`` read once (4
    bytes a padded cold slot) and ``cold_start`` written once (4 bytes a
    bag and one more); it computes nothing."""
    B, T, _ = split["hot_sel"].shape
    return _bound(split["cold_seg"].numel() * 4 + (B * T + 1) * 4, 0)


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


K10_PASSES = {"sgd": 3, "adagrad": 5, "adam": 7}   # leaf-sized reads + writes an element
K10_OPS = {"sgd": 2, "adagrad": 7, "adam": 14}     # the formulas' operations an element


def k10_bound(leaves: list, name: str) -> dict:
    """K10's least time for optimizer ``name`` over ``leaves``: each param,
    gradient and state element read once and each param and state element
    written once (sgd 3 passes, adagrad 5, adam 7), and the formula's
    operations an element (``ops/optimizer.py``)."""
    n = sum(p.numel() for p in leaves)
    nbytes = sum(p.numel() * p.element_size() for p in leaves) * K10_PASSES[name]
    return _bound(nbytes, n * K10_OPS[name])


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


def g_rows(g: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor):
    """The pooled gradient broadcast over the L slots (f32), its rows' mean
    squares and their fused rows: the K1b and K5 yardsticks' inputs."""
    B, T, L = indices.shape
    rows = g.float()[:, :, None, :].expand(B, T, L, g.shape[-1]).reshape(B * T * L, -1)
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    return rows.contiguous(), torch.mean(rows * rows, dim=-1), flat


def k10_library(name: str, learning_rate: float):
    """One PyTorch call over every leaf computing K10's function, where
    there is one, as ``fn(params, grads, states)``: sgd
    ``torch._foreach_add_(params, grads, alpha=-lr)``; adam torch's fused
    Adam step (``torch._fused_adam_``: mu and nu as optax's, the bias
    corrections applied as lr / bc1 and sqrt(nu) / sqrt(bc2), so the same
    function in another rounding), its step counts kept in f32 tensors
    beside it. None for adagrad: torch's divides by sqrt(acc) + eps, optax's
    multiplies by rsqrt(acc + eps), another function."""
    if name == "sgd":
        def sgd(params, grads, states):
            torch._foreach_add_(params, grads, alpha=-learning_rate)
        return sgd
    if name == "adagrad":
        return None
    steps: list = []

    def adam(params, grads, states):
        if not steps:
            steps.extend(torch.zeros((), dtype=torch.float32, device=p.device) for p in params)
        torch._foreach_add_(steps, 1)
        torch._fused_adam_(params, grads, states[0], states[1], [], steps, lr=learning_rate,
                           beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                           maximize=False)
    return adam


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


_MANGLED_TYPES = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}


def kernel_instance(mangled: str) -> str:
    """``name<arg, ...>`` of a mangled kernel template instance (Itanium ABI:
    ``...<len><name>I<args>E...``): types as ``bf16``/``f32``/``int8``,
    integer and bool arguments as numbers, a repeated type as ``S``."""
    at = mangled.find("_kernelI")
    if at < 0:
        return mangled
    end = at + len("_kernel")
    name = mangled[:end]
    for n in range(1, end):  # the name is the run of n chars right after the digits of n
        if mangled[end - n - len(str(n)):end - n] == str(n):
            name = mangled[end - n:end]
            break
    args, i = [], end + 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":                      # literal: L<type><value>E
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        elif mangled[i] == "S":                    # substitution: S_ or S<n>_
            j = mangled.index("_", i)
            args.append("S")
            i = j + 1
        elif mangled[i].isdigit():                 # <len><name>
            digits = re.match(r"\d+", mangled[i:]).group()
            n = int(digits)
            token = mangled[i:i + len(digits) + n]
            args.append(_MANGLED_TYPES.get(token, token[len(digits):]))
            i += len(digits) + n
        else:
            args.append(_MANGLED_TYPES.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(log: str) -> list:
    """``"<kernel><<template arguments>>: <registers> regs, <spills> B
    spilled"`` for every kernel instance in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = kernel_instance(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spilled")
            name, spill = None, "0"
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


def random_int8_tables(cfg, generator: torch.Generator, device) -> dict:
    """Full-size int8 tables of ``cfg``'s rows for timing: per-table ``{"q",
    "scale"}`` and row-wise ``{"qrows"}`` sharing the values, with positive
    random scales."""
    R, T, d = cfg.total_rows, cfg.num_tables, cfg.sparse_feature_size
    qrows = torch.empty((R, d + 4), dtype=torch.int8, device=device)
    qrows[:, :d] = torch.randint(-127, 128, (R, d), generator=generator, device=device,
                                 dtype=torch.int8)
    row_scale = torch.rand((R,), generator=generator, device=device) * 1e-2 + 1e-4
    qrows[:, d:] = row_scale.view(torch.int8).reshape(R, 4)
    del row_scale
    q = qrows[:, :d].contiguous()
    scale = torch.rand((T,), generator=generator, device=device) * 1e-2 + 1e-4
    return {"q": q, "scale": scale, "qrows": qrows}


def int8_instance_ptxas(lines: list, kernel: str, d: int, plan) -> str:
    """The ptxas line (registers, spills) of the instance of ``kernel``
    ("K1-int8" or "K4") that ``plan`` launches for bf16 output, from
    ``ptxas_summary`` of ``embedding_bag_int8.cu``'s build; "not found" if
    that build names its instances otherwise."""
    name = "embedding_bag_int8_kernel" if kernel == "K1-int8" else \
        "embedding_bag_int8_rowwise_kernel"
    G, U, lpr = plan.bags_per_warp, plan.rows_per_lane, 32 // plan.row_slots
    for prefix in (f"{name}<bf16, {d}, {lpr}, {G}, {U},", f"{name}<bf16, {d}, {G}, {U}>"):
        for line in lines:
            if line.startswith(prefix):
                return line.split(": ", 1)[1]
    return "not found"


def int8_id_streams(cfg, device) -> dict:
    """8 batches of ids for ``cfg`` at batch 512 on the card: "uniform", the
    port's generator (seed 3, as ``bench_k1``'s), and "zipf", zipf(1.2)
    folded into each table (``experiments.skew_bench.zipf_stream``, seeds
    2-9, as ``bench_k6``'s)."""
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.experiments.skew_bench import zipf_stream

    return {"uniform": [b.to(device).indices
                        for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)],
            "zipf": [torch.from_numpy(zipf_stream(cfg, BATCH, seed=2 + i)).to(device)
                     for i in range(8)]}


def bench_int8(log) -> list:
    """K1-int8 and K4 at every zoo shape (bf16 output, full-size int8
    tables, batch 512) on uniform and on zipf(1.2) ids (``int8_id_streams``):
    each kernel's time (the median of its launches in a profiler trace),
    rows/s, bound and the registers and spills of the instance its plan
    launches, beside K1's time on the same ids over a bf16 table of the same
    rows. No PyTorch call pools int8 rows (``F.embedding_bag`` takes float
    weights only), so these two kernels have no library time."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import (
        embedding_bag, embedding_bag_int8, embedding_bag_int8_reference,
        embedding_bag_int8_rowwise, embedding_bag_int8_rowwise_reference, k1_launch_plan,
        k4_launch_plan, rowwise_tolerance)

    device, bf16 = torch.device("cuda"), torch.bfloat16
    lines = ptxas_summary(_build.build("embedding_bag_int8").log)
    rows = []
    for name in zoo.MODEL_NAMES:
        cfg = zoo.get_config(name)
        g = torch.Generator(device=device).manual_seed(0)
        t = random_int8_tables(cfg, g, device)
        table = torch.empty((cfg.total_rows, cfg.sparse_feature_size), dtype=bf16,
                            device=device).uniform_(-0.05, 0.05, generator=g)
        offsets = table_offsets(cfg, device)
        for kind, batches in int8_id_streams(cfg, device).items():
            i0 = batches[0]
            B, T, L = i0.shape
            d = cfg.sparse_feature_size
            got = embedding_bag_int8(t["q"], t["scale"], offsets, i0, compute_dtype=bf16)
            if not torch.equal(got, embedding_bag_int8_reference(t["q"], t["scale"], offsets, i0,
                                                                 compute_dtype=bf16)):
                raise AssertionError(f"K1-int8 differs from its plain version at {name}, {kind}")
            got = embedding_bag_int8_rowwise(t["qrows"], offsets, i0, compute_dtype=bf16)
            want = embedding_bag_int8_rowwise_reference(t["qrows"], offsets, i0,
                                                        compute_dtype=bf16)
            if not bool(((got.float() - want.float()).abs()
                         <= rowwise_tolerance(got, want, t["qrows"], offsets, i0)).all()):
                raise AssertionError(f"K4 disagrees with its plain version at {name}, {kind}")
            ids = [(i,) for i in batches]
            k1i8 = measure(lambda i: embedding_bag_int8(t["q"], t["scale"], offsets, i,
                                                        compute_dtype=bf16), ids)
            k4 = measure(lambda i: embedding_bag_int8_rowwise(t["qrows"], offsets, i,
                                                              compute_dtype=bf16), ids)
            k1 = measure(lambda i: embedding_bag(table, offsets, i), ids)
            row = {"model": name, "ids": kind, "shape": [B, T, L, d],
                   "k1_int8": {**k1_int8_bound(t["q"], offsets, i0, bf16),
                               "ms": k1i8["kernel_ms"], "wall_ms": k1i8["wall_ms"],
                               "ptxas": int8_instance_ptxas(
                                   lines, "K1-int8", d, k1_launch_plan(B * T, L, d, torch.int8))},
                   "k4": {**k4_bound(t["qrows"], offsets, i0, bf16), "ms": k4["kernel_ms"],
                          "wall_ms": k4["wall_ms"],
                          "ptxas": int8_instance_ptxas(lines, "K4", d,
                                                       k4_launch_plan(B * T, L, d))},
                   "k1_bf16_ms": k1["kernel_ms"], "library_ms": None}
            for key in ("k1_int8", "k4"):
                r = row[key]
                r["rows_per_s"] = None if r["ms"] is None else B * T * L / (r["ms"] / 1e3)
            log(f"int8 {name} {kind} {row['shape']}: "
                + "; ".join(f"{label} {_us(row[key]['ms'])} ({_rate(row[key]['rows_per_s'])}, "
                            f"bound {_us(row[key]['bound_ms'])}; {row[key]['ptxas']})"
                            for key, label in (("k1_int8", "K1-int8"), ("k4", "K4")))
                + f"; K1 on a bf16 table, same ids {_us(row['k1_bf16_ms'])}")
            rows.append(row)
        del t, table
        torch.cuda.empty_cache()
    return rows


def _rate(rows_per_s) -> str:
    return "not measured" if rows_per_s is None else f"{rows_per_s / 1e9:.2f} G rows/s"


K6_MODELS = ("rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")  # every zoo shape
K6_LAYOUTS = ("none", "int8", "int8_rowwise")


def hotcold_inputs(name: str, table_quant: str, device, n_batches: int = 8, seed: int = 2,
                   table_scale: int = 1) -> dict:
    """K6's inputs at a zoo model's shape on zipf(1.2) ids: ``n_batches``
    batches of ``experiments.skew_bench.zipf_stream`` (seeds ``seed``,
    ``seed + 1``, ...), the hot set of the JAX package's rule chosen on the
    first (``skew_bench._hot_set``: ``suggest_hot_rows`` of the layout),
    random full-size tables of ``table_quant``'s layout (bf16 for "none"),
    the hot rows, and each batch's ids and native split on the card.
    Returns ``{"cfg", "tables", "rows"`` (the table of row-gathers),
    ``"hot_ids", "index"`` (its ``HotIndex``), ``"hot", "offsets", "streams"``
    (host ids), ``"batches": [(indices, split)], "coverage", "hot_rows",
    "n_cold"}``."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.experiments.skew_bench import _hot_set, zipf_stream
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
    from deeprecsys_tpu_torch.ops.hotcold import split_hot_cold
    from deeprecsys_tpu_torch.runtime.native import HotIndex

    cfg = zoo.get_config(name, table_scale=table_scale, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=table_quant)
    streams = [zipf_stream(cfg, BATCH, seed=seed + i) for i in range(n_batches)]
    hot_ids, coverage = _hot_set(cfg, streams[0])
    index = HotIndex(hot_ids)
    g = torch.Generator(device=device).manual_seed(0)
    if table_quant == "none":
        tables = torch.empty((cfg.total_rows, cfg.sparse_feature_size), dtype=torch.bfloat16,
                             device=device).uniform_(-0.05, 0.05, generator=g)
        rows = tables
    else:
        t = random_int8_tables(cfg, g, device)
        tables = ({"q": t["q"], "scale": t["scale"]} if table_quant == "int8"
                  else {"qrows": t["qrows"]})
        rows = tables["q"] if table_quant == "int8" else tables["qrows"]
        del t
    offsets = np.asarray(cfg.table_offsets, dtype=np.int64)
    batches, n_cold = [], []
    for idx in streams:
        sp = split_hot_cold(idx, offsets, hot_ids, impl="native", hot_index=index,
                            cold_buckets=cold_buckets_for(idx.size))
        n_cold.append(sp["n_cold"])
        batches.append((torch.from_numpy(idx).to(device),
                        {k: torch.from_numpy(np.ascontiguousarray(sp[k])).to(device)
                         for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}))
    return {"cfg": cfg, "tables": tables, "rows": rows, "hot_ids": hot_ids, "index": index,
            "hot": rows.index_select(0, torch.as_tensor(hot_ids, device=device)),
            "offsets": table_offsets(cfg, device), "streams": streams, "batches": batches,
            "coverage": coverage, "hot_rows": int(len(hot_ids)), "n_cold": n_cold}


def k6_call(quant: str, hot, tables, split: dict, cdt: torch.dtype, plain: bool = False):
    """K6 (or, ``plain``, its plain version) for ``quant``'s table layout
    ("none", "int8" or "int8_rowwise")."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    if quant == "none":
        fn = emb.embedding_bag_hotcold_reference if plain else emb.embedding_bag_hotcold
        return fn(hot, tables, split, compute_dtype=cdt)
    if quant == "int8":
        fn = emb.embedding_bag_hotcold_int8_reference if plain else emb.embedding_bag_hotcold_int8
        return fn(hot, tables["q"], tables["scale"], split, compute_dtype=cdt)
    fn = (emb.embedding_bag_hotcold_int8_rowwise_reference if plain
          else emb.embedding_bag_hotcold_int8_rowwise)
    return fn(hot, tables["qrows"], split, compute_dtype=cdt)


def direct_call(quant: str, tables, offsets, indices, cdt: torch.dtype, mask=None):
    """The direct kernel of ``quant``'s layout (K1, K1-int8, K4)."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    if quant == "none":
        return emb.embedding_bag(tables, offsets, indices, compute_dtype=cdt, mask=mask)
    if quant == "int8":
        return emb.embedding_bag_int8(tables["q"], tables["scale"], offsets, indices,
                                      compute_dtype=cdt, mask=mask)
    return emb.embedding_bag_int8_rowwise(tables["qrows"], offsets, indices, compute_dtype=cdt,
                                          mask=mask)


def hotcold_calls(inp: dict, quant: str, cdt: torch.dtype = torch.bfloat16) -> dict:
    """K6, its plain version and the direct kernel of the layout on
    ``hotcold_inputs``' tables, as functions of ``(indices, split)``;
    ``library``: ``F.embedding_bag`` on the original ids over the float
    table (K6's yardstick: the same pooled sums), None for the int8
    layouts; ``bound``: ``k6_bound`` of a batch."""
    tables, hot, offsets = inp["tables"], inp["hot"], inp["offsets"]
    lib = k1_library(tables, offsets) if quant == "none" else None
    return {"kernel": lambda i, s: k6_call(quant, hot, tables, s, cdt),
            "plain": lambda i, s: k6_call(quant, hot, tables, s, cdt, plain=True),
            "direct": lambda i, s: direct_call(quant, tables, offsets, i, cdt),
            "library": None if lib is None else (lambda i, s: lib(i)),
            "bound": lambda i, s: k6_bound(hot, inp["rows"], s, cdt,
                                           "float" if quant == "none" else quant)}


HOST_REPS = 21  # host_us runs a K6 row takes the median of


def bench_k6(log) -> list:
    """K6 at every zoo model's shape on zipf(1.2) ids with the JAX hot-set
    rule, in the three layouts
    (bf16 output, 8 batches): device time a call, the sum of all of its
    launches (``launch_sum_ms``; each launch's mean beside it), beside its
    bound, its span (``span_ms``, the direct kernel's beside it), the wall
    time a call, the wrapper's host time a call and the direct wrapper's
    (each the median of ``HOST_REPS`` runs of ``host_us``), the direct
    kernel's time on the same ids and, for float tables,
    ``F.embedding_bag``'s. Where K6 has a ``cold_start`` launch, that
    launch's median time stands beside its own bound
    (``cold_starts_bound``)."""
    device = torch.device("cuda")
    rows = []
    for name in K6_MODELS:
        for quant in K6_LAYOUTS:
            inp = hotcold_inputs(name, quant, device)
            calls = hotcold_calls(inp, quant)
            i0, s0 = inp["batches"][0]
            got, direct = calls["kernel"](i0, s0), calls["direct"](i0, s0)
            err = (got.float() - direct.float()).abs().max().item()
            if quant == "int8" and not torch.equal(got, direct):
                raise AssertionError(f"K6-int8 differs from K1-int8 at {name}")
            run = measure(calls["kernel"], inp["batches"])
            dk = measure(calls["direct"], inp["batches"])
            lib = None if calls["library"] is None else measure(calls["library"], inp["batches"])
            starts_ms = named_kernel_ms(run, "cold_starts")
            row = {"model": name, "layout": quant, "shape": list(i0.shape),
                   "hot_rows": inp["hot_rows"], "coverage": inp["coverage"],
                   "n_cold": inp["n_cold"][0], **calls["bound"](i0, s0),
                   "ms": run["launch_sum_ms"], "span_ms": span_ms(calls["kernel"], inp["batches"]),
                   "direct_span_ms": span_ms(calls["direct"], inp["batches"]),
                   "wall_ms": run["wall_ms"],
                   "launches": run["launches"], "us_by_kernel": run["us_by_kernel"],
                   "cold_starts_ms": starts_ms,
                   "cold_starts_bound_ms": cold_starts_bound(s0)["bound_ms"],
                   "host_us": host_us(calls["kernel"], (i0, s0), reps=HOST_REPS),
                   "direct_host_us": host_us(calls["direct"], (i0, s0), reps=HOST_REPS),
                   "direct_ms": dk["kernel_ms"],
                   "library_ms": None if lib is None else lib["device_ms"],
                   "max_abs_err_vs_direct": err}
            log(f"K6 {name} {quant} {row['shape']} (coverage {row['coverage']:.4f} of "
                f"{row['hot_rows']} hot rows): {_us(row['ms'])} in {row['launches']:.0f} "
                f"launches ({_by_kernel(row['us_by_kernel'])}); span {_us(row['span_ms'])} "
                f"(direct {_us(row['direct_span_ms'])}); wall {_us(row['wall_ms'])}; "
                f"host {row['host_us']:.2f} us a call (direct {row['direct_host_us']:.2f}); "
                f"bound {_us(row['bound_ms'])} ({row['bound_by']}); direct kernel "
                f"{_us(row['direct_ms'])}; F.embedding_bag {_us(row['library_ms'])}; "
                f"max |K6 - direct| {err:.3e}")
            if starts_ms is not None:
                log(f"K6 {name} {quant} cold_start launch: {_us(row['cold_starts_ms'])}; bound "
                    f"{_us(row['cold_starts_bound_ms'])} (bytes: cold_seg read, cold_start "
                    f"written)")
            rows.append(row)
            del inp, calls
            torch.cuda.empty_cache()
    return rows


def _by_kernel(us_by_kernel: dict) -> str:
    def short(name):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        return name.split("(")[0].split("<")[0][-40:]
    return ", ".join(f"{short(name)} {us:.2f} us"
                     for name, us in sorted(us_by_kernel.items(), key=lambda kv: -kv[1]))


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


def k3b_inputs(T: int, B: int, w_dtype: torch.dtype, device, seed: int = 0) -> dict:
    """K3b's inputs at (T, B, 64): a forward scan's f32 tanh values ``y``
    (teacher-forced from the plain loop's states, as
    ``RnnScanFunction.backward`` forms them), a random gradient ``gh`` of
    every state, the weights, and lengths in [0, T] (row 0 of length 0);
    ``xproj`` and ``b`` for the library yardstick."""
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan_reference

    g = torch.Generator(device=device).manual_seed(seed)
    H = 64
    xproj = torch.randn((T, B, H), generator=g, device=device)
    w = (torch.randn((H, H), generator=g, device=device) / H ** 0.5).to(w_dtype)
    b = (torch.randn((H,), generator=g, device=device) * 0.1).to(w_dtype)
    all_h, _ = rnn_scan_reference(xproj, w, b, torch.float32)
    prev = torch.cat([torch.zeros_like(all_h[:1]), all_h[:-1]])
    y = torch.tanh((xproj + prev @ w.float()) + b.float())
    gh = torch.randn((T, B, H), generator=g, device=device)
    lens = torch.randint(0, T + 1, (B,), generator=g, device=device, dtype=torch.int32)
    lens[0] = 0
    return {"xproj": xproj, "w": w, "b": b, "y": y, "gh": gh, "lens": lens}


K3B_SHAPES = ((DIEN_T, 128), (DIEN_T, BATCH))  # (T, B): the trainer's batch and the forward's
K3B_RTOL = 1e-5  # of the largest |delta|, as chip_smoke.py holds K3b


def k3b_error(fn, inp: dict, lens) -> float:
    """``fn``'s (K3b or an instance of it) largest |error| against the
    plain loop over delta and dh0, as a share of the largest |delta| (or
    |dh0|); raises past ``K3B_RTOL``."""
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan_backward_reference

    delta, dh0 = fn(inp["y"], inp["gh"], inp["w"], lens)
    want_d, want_h = rnn_scan_backward_reference(inp["y"], inp["gh"], inp["w"], lens)
    scale = max(want_d.abs().max().item(), want_h.abs().max().item())
    err = max((delta - want_d).abs().max().item(), (dh0 - want_h).abs().max().item()) / scale
    if err > K3B_RTOL:
        raise AssertionError(f"K3b disagrees with its plain loop: {err:.3e} of the largest "
                             f"|delta| (limit {K3B_RTOL:.0e})")
    return err


def bench_k3b(log) -> list:
    """K3b at ``K3B_SHAPES`` with f32 and bf16 weights: checked against the
    plain loop with and without seq_lengths, then its median device time
    (no seq_lengths, as the trainer's timing runs it) beside its bound,
    cuDNN's backward-data pass, the plain loop and the wrapper's host time
    a call (the median of ``HOST_REPS`` runs of ``host_us``)."""
    with torch.inference_mode(False):  # the library yardstick runs autograd
        return _bench_k3b(log)


def _bench_k3b(log) -> list:
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan_backward, rnn_scan_backward_reference

    device = torch.device("cuda")
    rows = []
    for T, B in K3B_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            inp = k3b_inputs(T, B, dt, device, seed=T + B)
            err = max(k3b_error(rnn_scan_backward, inp, m) for m in (None, inp["lens"]))
            args = [(inp["y"], inp["gh"], inp["w"])]
            run = measure(rnn_scan_backward, args, 50)
            plain = measure(rnn_scan_backward_reference, args, 10)
            lib = measure(k3b_library(inp["w"], inp["b"], inp["xproj"]), [(inp["gh"].to(dt),)],
                          50)
            row = {"shape": [T, B, 64], "w_dtype": str(dt)[6:], **k3b_bound(T, B, 64),
                   "ms": run["kernel_ms"], "wall_ms": run["wall_ms"],
                   "plain_ms": plain["device_ms"], "library_ms": lib["device_ms"],
                   "host_us": host_us(rnn_scan_backward, args[0], reps=HOST_REPS),
                   "max_rel_err": err}
            rows.append(row)
            log(f"K3b T={T} B={B} W {row['w_dtype']}: {_us(row['ms'])} (device, median); bound "
                f"{_us(row['bound_ms'])} ({row['bound_by']}); cuDNN backward-data "
                f"{_us(row['library_ms'])}; plain loop {_us(row['plain_ms'])}; wall "
                f"{_us(row['wall_ms'])}; host {row['host_us']:.2f} us a call; max |err| "
                f"{err:.2e} of the largest |delta|")
            del inp
    return rows


K5_MODELS = ("rm1", "dien")  # the sparse steps' shapes: rm1 L 80, dien L 1 (d 32)
K5_BATCH = 128               # the train CLI's batch


def k5_inputs(name: str, device, n_batches: int = 8, seed: int = 3) -> dict:
    """``name``'s full-size table rows, ``n_batches`` batches of the
    generator's ids (batch ``K5_BATCH``) and random f32 pooled gradients."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models.base import table_offsets

    cfg = zoo.get_config(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = [b.to(device).indices for b in
           RecDataGenerator(cfg, seed=seed).generate_batches(n_batches, K5_BATCH)]
    gs = [torch.randn((K5_BATCH, cfg.num_tables, cfg.sparse_feature_size), generator=gen,
                      device=device) * 1e-2 for _ in ids]
    return {"R": cfg.total_rows, "d": cfg.sparse_feature_size,
            "offsets": table_offsets(cfg, device), "ids": ids, "gs": gs, "gen": gen}


def k5_tables(inp: dict, table_dtype: torch.dtype, acc_scale: float = 0.0) -> tuple:
    """A random ``(R, d)`` table of ``table_dtype`` and an accumulator,
    zero or uniform in [0, ``acc_scale``)."""
    R, d, gen = inp["R"], inp["d"], inp["gen"]
    device = inp["offsets"].device
    table = ((torch.rand((R, d), generator=gen, device=device) - 0.5) * 0.1).to(table_dtype)
    acc = torch.rand((R,), generator=gen, device=device) * acc_scale
    return table, acc


def k5_check(fn, inp: dict, table_dtype: torch.dtype) -> dict:
    """``fn(table, acc, offsets, indices, g)`` (K5 or a variant of it) on
    the first batch against the plain version: raises past
    ``sparse_adagrad_tolerance``; returns the largest |error| and, of the
    rows that take one add, how many there are and in how many the
    accumulator differs from the plain version's at all."""
    from deeprecsys_tpu_torch.ops import sparse_adagrad_step_reference
    from deeprecsys_tpu_torch.ops.embedding import scatter_counts
    from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_tolerance

    offsets, indices, g = inp["offsets"], inp["ids"][0], inp["gs"][0]
    table0, acc0 = k5_tables(inp, table_dtype, 1e-4)
    table, acc = table0.clone(), acc0.clone()
    fn(table, acc, offsets, indices, g)
    torch.cuda.synchronize()
    want_t, want_a = table0.clone(), acc0.clone()
    sparse_adagrad_step_reference(want_t, want_a, offsets, indices, g, 0.1)
    tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, indices, g, 0.1)
    err, acc_err = (table.float() - want_t.float()).abs(), (acc - want_a).abs()
    if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
        raise AssertionError(f"K5 disagrees with the plain version: max |err| table "
                             f"{err.max().item():.3e}, acc {acc_err.max().item():.3e}")
    once = scatter_counts(offsets, indices, acc.shape[0]) == 1
    return {"max_abs_err": max(err.max().item(), acc_err.max().item()),
            "rows_once": int(once.sum()), "acc_differ_once": int((once & (acc != want_a)).sum())}


def bench_k5(log) -> list:
    """K5 at the sparse steps' shapes (``K5_MODELS``, full-size tables,
    batch 128, 8 batches of the generator's ids) with f32 and bf16 tables:
    checked against its plain version, then its span (``span_ms``: launch
    1's start to launch 2's end), the sum of its launches' medians, its
    bound, the plain version, the ``index_add_`` yardstick
    (``k5_library``) and the wrapper's host time a call (the median of
    ``HOST_REPS`` runs)."""
    from deeprecsys_tpu_torch.ops import sparse_adagrad_step, sparse_adagrad_step_reference

    device = torch.device("cuda")
    rows = []
    for name in K5_MODELS:
        inp = k5_inputs(name, device)
        offsets = inp["offsets"]
        for tdt in (torch.float32, torch.bfloat16):
            chk = k5_check(lambda t, a, o, i, g: sparse_adagrad_step(t, a, o, i, g, 0.1), inp, tdt)
            table, acc = k5_tables(inp, tdt)
            args = list(zip(inp["ids"], inp["gs"]))

            def kernel(i, g):
                sparse_adagrad_step(table, acc, offsets, i, g, 0.1)

            def plain(i, g):
                sparse_adagrad_step_reference(table, acc, offsets, i, g, 0.1)
            run = measure(kernel, args)
            pl = measure(plain, args, 20)
            lib = measure(k5_library(table, acc, 0.1), [g_rows(g, offsets, i) for i, g in args])
            row = {"model": name, "shape": list(inp["ids"][0].shape) + [inp["d"]],
                   "table_dtype": str(tdt)[6:],
                   **k5_bound(table, inp["gs"][0], offsets, inp["ids"][0]),
                   "ms": run["launch_sum_ms"], "span_ms": span_ms(kernel, args, 100),
                   "wall_ms": run["wall_ms"], "us_by_kernel": run["us_by_kernel"],
                   "plain_ms": pl["device_ms"], "library_ms": lib["device_ms"],
                   "host_us": host_us(kernel, args[0], reps=HOST_REPS), **chk}
            rows.append(row)
            log(f"K5 {name} {row['shape']} table {row['table_dtype']}: launches "
                f"{_us(row['ms'])} ({_by_kernel(row['us_by_kernel'])}); span "
                f"{_us(row['span_ms'])}; bound {_us(row['bound_ms'])} ({row['bound_by']}); plain "
                f"{_us(row['plain_ms'])}; index_add_ sequence {_us(row['library_ms'])}; wall "
                f"{_us(row['wall_ms'])}; host {row['host_us']:.2f} us a call; max |err| "
                f"{chk['max_abs_err']:.2e}; accumulator unequal to the plain one in "
                f"{chk['acc_differ_once']} of {chk['rows_once']} rows of one add")
            del table, acc
        del inp
        torch.cuda.empty_cache()
    return rows


K10_MODEL = "rm1"  # the dense step's params: a 32 M x 32 f32 table and the MLPs


def k10_inputs(device, seed: int = 7, table_scale: int = 1) -> tuple:
    """``K10_MODEL``'s f32 params (full-size at ``table_scale`` 1) as the
    trainer's leaves, and random gradients scaled to 1e-2."""
    from deeprecsys_tpu_torch import bridge, zoo
    from deeprecsys_tpu_torch.models import get_model

    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(zoo.get_config(K10_MODEL, table_scale=table_scale), device).init(gen)
    leaves = list(bridge.flatten(params).values())
    grads = [torch.randn(p.shape, generator=gen, device=device) * 1e-2 for p in leaves]
    return leaves, grads


def bench_k10(log) -> list:
    """The trainer's optimizer update (``train.make_optimizer(name,
    0.1).update``, which launches K10 where the port has it) over rm1's
    full-size f32 params, for sgd, adagrad and adam: its device time, wall
    time and device ops a call beside ``k10_bound``; where the port has
    ``ops.optimizer`` also the plain version's time, K10 held bit for bit
    to it (one step from the same state), and ``k10_library``'s call."""
    import importlib.util

    from deeprecsys_tpu_torch.train import make_optimizer

    has_k10 = importlib.util.find_spec("deeprecsys_tpu_torch.ops.optimizer") is not None
    device = torch.device("cuda")
    leaves, grads = k10_inputs(device)
    rows = []
    for name in ("sgd", "adagrad", "adam"):
        opt = make_optimizer(name, 0.1)
        state = opt.init(leaves)
        run = measure(lambda: opt.update(leaves, grads, state), [()], 10)
        row = {"optimizer": name, "leaves": len(leaves), **k10_bound(leaves, name),
               "ms": run["device_ms"], "wall_ms": run["wall_ms"], "device_ops": run["launches"]}
        if has_k10:
            from deeprecsys_tpu_torch.ops.optimizer import (
                optimizer_update, optimizer_update_reference)

            if name == "adam":
                states, count = [state["mu"], state["nu"]], state["count"]
            else:
                states, count = ([state] if name == "adagrad" else []), 0
            ps, ss = [p.clone() for p in leaves], [[t.clone() for t in s] for s in states]
            optimizer_update(name, ps, grads, ss, 0.1, count + 1)
            optimizer_update_reference(name, leaves, grads, states, 0.1, count + 1)
            torch.cuda.synchronize()
            row["bit_for_bit"] = all(torch.equal(a, b) for a, b in zip(
                ps + [t for s in ss for t in s], leaves + [t for s in states for t in s]))
            del ps, ss
            if not row["bit_for_bit"]:
                raise AssertionError(f"K10 {name} differs from its plain version")
            plain = measure(lambda: optimizer_update_reference(name, leaves, grads, states, 0.1,
                                                               count + 1), [()], 5)
            row["plain_ms"] = plain["device_ms"]
            lib = k10_library(name, 0.1)
            row["library_ms"] = None if lib is None else measure(
                lambda: lib(leaves, grads, states), [()], 10)["device_ms"]
        rows.append(row)
        log(f"optimizer update {name} over {K10_MODEL}'s {len(leaves)} f32 leaves: "
            f"{_us(row['ms'])} in {row['device_ops']:.0f} device ops; wall {_us(row['wall_ms'])}; "
            f"bound {_us(row['bound_ms'])} ({row['bound_by']}, {row['bytes'] / 1e9:.3f} GB)"
            + (f"; plain {_us(row['plain_ms'])}; library {_us(row['library_ms'])}; K10 bit for "
               f"bit the plain version" if has_k10 else "; (no K10 in this tree)"))
        del state
        torch.cuda.empty_cache()
    return rows


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


BENCHES = {"k1": bench_k1, "k1_host": bench_k1_host, "k3": bench_k3, "int8": bench_int8,
           "k6": bench_k6, "k3b": bench_k3b, "k5": bench_k5, "k10": bench_k10}  # --only's names


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--only", type=str, default=",".join(BENCHES),
                   help="comma-separated benches to run (default: all)")
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
    for key in ("embedding_bag", "rnn_scan", "embedding_bag_int8", "embedding_bag_hotcold",
                "rnn_scan_backward", "sparse_adagrad", "optimizer_update"):
        if (_build.CSRC / f"{key}.cu").exists():  # an older checkout lacks the newer kernels
            log(f"{key}: ptxas " + "; ".join(ptxas_summary(_build.build(key).log)))
    res = {"card": card}
    with torch.inference_mode():
        for key in args.only.split(","):
            res[key] = BENCHES[key](log)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
