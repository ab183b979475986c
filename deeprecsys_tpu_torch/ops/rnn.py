"""Scanned basic tanh RNN for DIEN.

Counterpart of ``deeprecsys_tpu/ops/rnn.py``: Caffe2's ``BasicRNN``
(forward-only, tanh), used twice in DIEN's GRU unit,

    h_t = tanh(x_t @ i2h_w + i2h_b + h_{t-1} @ h2h_w + h2h_b)

over a time-major ``(T, B, in)`` input. As in the JAX op, the input
projection of all steps is one hoisted matmul (f32 plus the f32 bias) and
only the recurrence is serial. ``rnn_scan`` is the recurrence's dispatch:
on CUDA tensors it launches the hand-written Hopper kernel K3
(``csrc/rnn_scan.cu``, one launch a scan), on CPU tensors it runs the
plain loop ``rnn_scan_reference``. Numerics follow the JAX op: the dot
accumulates in f32, then ``xp + dot``, then ``+ h2h_b``, tanh in f32, and
the hidden state is stored in the input dtype at every step.

The init keeps the JAX package's deliberate departure from the reference:
1/sqrt(fan_in) weights and zero biases (``deeprecsys_tpu/ops/rnn.py:13-22``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from deeprecsys_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HIDDEN = 64  # the zoo's hidden size, the only one K3 is built for


def basic_rnn_init(input_size: int, hidden_size: int, dtype: torch.dtype,
                   generator: torch.Generator, device: torch.device | str) -> dict:
    """1/sqrt(fan_in)-scaled N(0, 1) weights, zero biases."""
    def weight(n, m):
        w = torch.randn((n, m), generator=generator, device=device) / math.sqrt(n)
        return w.to(dtype)

    return {
        "i2h_w": weight(input_size, hidden_size),
        "i2h_b": torch.zeros((hidden_size,), dtype=dtype, device=device),
        "h2h_w": weight(hidden_size, hidden_size),
        "h2h_b": torch.zeros((hidden_size,), dtype=dtype, device=device),
    }


def rnn_scan_reference(xproj: torch.Tensor, h2h_w: torch.Tensor, h2h_b: torch.Tensor,
                       out_dtype: torch.dtype, h0: torch.Tensor | None = None,
                       seq_lengths: torch.Tensor | None = None):
    """Plain PyTorch recurrence: a Python loop over the T steps."""
    T, B, H = xproj.shape
    w, b = h2h_w.float(), h2h_b.float()
    h = (torch.zeros((B, H), dtype=out_dtype, device=xproj.device) if h0 is None
         else h0.to(out_dtype))
    alive = None
    if seq_lengths is not None:
        alive = (torch.arange(T, device=xproj.device)[:, None]
                 < seq_lengths.to(torch.int32)[None, :])[..., None]
    out = []
    for t in range(T):
        new_h = torch.tanh((xproj[t] + h.float() @ w) + b).to(out_dtype)
        h = new_h if alive is None else torch.where(alive[t], new_h, h)
        out.append(h)
    all_h = torch.stack(out) if out else xproj.new_empty((0, B, H), dtype=out_dtype)
    return all_h, h


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("rnn_scan")
    lib.drs_rnn_scan.restype = ctypes.c_int
    lib.drs_rnn_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # xproj, w, b, w dtype
        ctypes.c_void_p, ctypes.c_void_p,                                   # h0, seq_lengths
        ctypes.c_void_p, ctypes.c_int,                                      # all_h, out dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                           # T, B, H
        ctypes.c_void_p,                                                    # stream
    ]
    lib.drs_cuda_error_string.restype = ctypes.c_char_p
    lib.drs_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths):
    """Raise on anything the kernel does not take (both devices share the
    contract, so the CPU tests exercise these checks too)."""
    if xproj.dim() != 3 or xproj.dtype != torch.float32:
        raise TypeError(f"xproj must be (T, B, H) float32; got "
                        f"{tuple(xproj.shape)} {xproj.dtype}")
    T, B, H = xproj.shape
    if H != KERNEL_HIDDEN:
        raise ValueError(f"the RNN scan kernel is built for hidden size "
                         f"{KERNEL_HIDDEN} only; got H = {H}")
    if h2h_w.shape != (H, H) or h2h_b.shape != (H,):
        raise ValueError(f"h2h_w must be ({H}, {H}) and h2h_b ({H},); got "
                         f"{tuple(h2h_w.shape)} and {tuple(h2h_b.shape)}")
    if h2h_w.dtype not in _DTYPE_CODES or h2h_b.dtype != h2h_w.dtype \
            or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"h2h_w and h2h_b must share a dtype, and it and the output "
                        f"dtype must be float32 or bfloat16; got {h2h_w.dtype}, "
                        f"{h2h_b.dtype} and {out_dtype}")
    if h0 is not None and (h0.shape != (B, H) or not h0.is_floating_point()):
        raise TypeError(f"h0 must be a float ({B}, {H}) tensor; got "
                        f"{tuple(h0.shape)} {h0.dtype}")
    if seq_lengths is not None and (seq_lengths.shape != (B,)
                                    or seq_lengths.is_floating_point()):
        raise TypeError(f"seq_lengths must be an integer ({B},) tensor; got "
                        f"{tuple(seq_lengths.shape)} {seq_lengths.dtype}")
    tensors = [t for t in (xproj, h2h_w, h2h_b, h0, seq_lengths) if t is not None]
    if any(t.device != xproj.device for t in tensors):
        raise ValueError("xproj, h2h_w, h2h_b, h0 and seq_lengths must be on one device")


def rnn_scan(xproj: torch.Tensor, h2h_w: torch.Tensor, h2h_b: torch.Tensor,
             out_dtype: torch.dtype, h0: torch.Tensor | None = None,
             seq_lengths: torch.Tensor | None = None):
    """The recurrence of ``basic_rnn_scan`` (JAX ``ops/rnn.py:72-91``).

    Args:
      xproj: ``(T, B, H)`` float32, the hoisted projection ``x @ i2h_w + i2h_b``.
      h2h_w, h2h_b: ``(H, H)`` and ``(H,)``, float32 or bfloat16, H = 64.
      out_dtype: the compute dtype, float32 or bfloat16; the hidden state is
        rounded to it at every step.
      h0: optional ``(B, H)`` initial state (zeros if None), cast to out_dtype.
      seq_lengths: optional ``(B,)`` ints; row b stops updating once
        ``t >= seq_lengths[b]``.

    Returns:
      ``(all_h (T, B, H), last (B, H))`` in ``out_dtype``.

    CPU tensors take ``rnn_scan_reference``. CUDA tensors launch K3 once,
    one block a batch row, and count the launch in
    ``rnn_scan.kernel_launches``; a failed build or launch raises.
    """
    _check(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths)
    if xproj.device.type == "cpu":
        return rnn_scan_reference(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths)
    if xproj.device.type != "cuda":
        raise ValueError(f"rnn_scan runs on cpu or cuda, not {xproj.device}")
    T, B, H = xproj.shape
    h_init = None if h0 is None else h0.to(out_dtype).float().contiguous()
    if T == 0 or B == 0:
        last = (torch.zeros((B, H), dtype=out_dtype, device=xproj.device)
                if h_init is None else h_init.to(out_dtype))
        return xproj.new_empty((T, B, H), dtype=out_dtype), last
    lens = None if seq_lengths is None else seq_lengths.to(torch.int32).contiguous()
    xproj, w, b = xproj.contiguous(), h2h_w.contiguous(), h2h_b.contiguous()
    if xproj.data_ptr() % 16:
        raise ValueError("the kernel copies xproj in 16-byte pieces: it must start "
                         "on a 16-byte boundary")
    all_h = torch.empty((T, B, H), dtype=out_dtype, device=xproj.device)
    _build.launch(_kernel_lib(), "drs_rnn_scan", xproj.device,
                  xproj.data_ptr(), w.data_ptr(), b.data_ptr(), _DTYPE_CODES[w.dtype],
                  None if h_init is None else h_init.data_ptr(),
                  None if lens is None else lens.data_ptr(),
                  all_h.data_ptr(), _DTYPE_CODES[out_dtype], T, B, H)
    rnn_scan.kernel_launches += 1
    return all_h, all_h[-1]


rnn_scan.kernel_launches = 0


def basic_rnn_scan(params: dict, xs: torch.Tensor, h0: torch.Tensor | None = None,
                   seq_lengths: torch.Tensor | None = None):
    """Run the RNN over time-major ``xs`` of shape ``(T, B, in)``.

    Returns ``(all_hidden (T, B, H), last_hidden (B, H))`` in ``xs``'s dtype.
    With ``seq_lengths``, row b's state freezes at its own length, so
    ``last_hidden[b]`` equals an unpadded run of length ``seq_lengths[b]``.
    """
    T, B, _ = xs.shape
    H = params["h2h_w"].shape[0]
    # Hoisted input projection: one matmul for all steps, f32 plus f32 bias.
    xproj = xs.reshape(T * B, -1).float() @ params["i2h_w"].float()
    xproj = (xproj + params["i2h_b"].float()).reshape(T, B, H)
    return rnn_scan(xproj, params["h2h_w"], params["h2h_b"], xs.dtype,
                    h0=h0, seq_lengths=seq_lengths)


def rnn_scan_tolerance(all_h: torch.Tensor, xproj: torch.Tensor, h2h_w: torch.Tensor,
                       h2h_b: torch.Tensor, h0: torch.Tensor | None = None,
                       seq_lengths: torch.Tensor | None = None):
    """Teacher-forced check of a recurrence's output ``all_h``: each step
    recomputed in f32 from the output's own previous state, and the
    elementwise bound on |step - all_h| for two implementations that differ
    only in the order of the f32 dot.

    Returns ``(step, tol)``, both ``(T, B, H)`` f32. The bound is the f32
    summation slack of the dot, (H + 2) * 2^-23 * (|xp| + sum_k |h_k W_kj| +
    |b|) (tanh' <= 1), plus 4 f32 ulps of the result for tanh's own error,
    plus one ulp of the output dtype where each side rounds once; 0 where
    a row is frozen.
    """
    T, B, H = all_h.shape
    dt = all_h.dtype
    prev = torch.zeros((1, B, H), dtype=dt, device=all_h.device) if h0 is None \
        else h0.to(dt)[None]
    prev = torch.cat([prev, all_h[:-1]]).float()
    w, b = h2h_w.float(), h2h_b.float()
    step = torch.tanh((xproj + prev @ w) + b).to(dt).float()
    mag = xproj.abs() + prev.abs() @ w.abs() + b.abs()
    out = torch.maximum(step.abs(), all_h.float().abs())
    tol = (H + 2) * 2.0 ** -23 * mag + 4 * 2.0 ** -23 * out
    if dt == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            torch.clamp(out, min=torch.finfo(torch.float32).tiny))) - 7)
    if seq_lengths is not None:  # a frozen row keeps its state exactly
        alive = (torch.arange(T, device=all_h.device)[:, None]
                 < seq_lengths.to(torch.int32)[None, :])[..., None]
        step, tol = torch.where(alive, step, prev), torch.where(alive, tol, 0.0)
    return step, tol
