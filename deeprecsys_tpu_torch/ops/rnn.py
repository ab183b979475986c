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

Under autograd (grad enabled and an input that requires grad, as in the
trainer) the recurrence runs as ``RnnScanFunction``: forward K3, backward
``rnn_scan_backward``, the reverse scan, kernel K3b
(``csrc/rnn_scan_backward.cu``) on the card and the plain loop
``rnn_scan_backward_reference`` on the CPU. Inference and serving call the
dispatch directly.

The init keeps the JAX package's deliberate departure from the reference:
1/sqrt(fan_in) weights and zero biases (``deeprecsys_tpu/ops/rnn.py:13-22``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeprecsys_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HIDDEN = 64  # the zoo's hidden size: K3's and K3b's tuned instances
# K3 and K3b run a batch row on one block, a thread a hidden unit: the
# card's largest block (1024 threads) bounds H. Every H but KERNEL_HIDDEN
# takes their general instances.
MAX_HIDDEN = 1024


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


def _declare(lib: ctypes.CDLL):
    lib.drs_rnn_scan.restype = ctypes.c_int
    lib.drs_rnn_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # xproj, w, b, w dtype
        ctypes.c_void_p, ctypes.c_void_p,                                   # h0, seq_lengths
        ctypes.c_void_p, ctypes.c_int,                                      # all_h, out dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                           # T, B, H
        ctypes.c_void_p,                                                    # stream
    ]


def _kernel_lib() -> ctypes.CDLL:
    return _build.load("rnn_scan", _declare)


def _check_hidden(H: int):
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"the RNN scan kernels run a thread a hidden unit, at most "
                         f"{MAX_HIDDEN} (the card's block size); got H = {H}")


def _check(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths):
    """Raise on anything the kernel does not take (both devices share the
    contract, so the CPU tests exercise these checks too)."""
    if xproj.dim() != 3 or xproj.dtype != torch.float32:
        raise TypeError(f"xproj must be (T, B, H) float32; got "
                        f"{tuple(xproj.shape)} {xproj.dtype}")
    T, B, H = xproj.shape
    _check_hidden(H)
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
      h2h_w, h2h_b: ``(H, H)`` and ``(H,)``, float32 or bfloat16, 1 <= H <=
        1024 (H = 64 takes the tuned instance, any other H the general one).
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
    if torch.is_grad_enabled() and xproj.shape[0] > 0 and any(
            t is not None and t.requires_grad for t in (xproj, h2h_w, h2h_b, h0)):
        # all_h[-1] is a view of all_h, so the gradients of the two outputs add.
        all_h = RnnScanFunction.apply(xproj, h2h_w, h2h_b, h0, seq_lengths, out_dtype)
        return all_h, all_h[-1]
    return _dispatch(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths)


def _dispatch(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths):
    """The plain loop on the CPU, K3 on the card (checked inputs)."""
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
    if H == KERNEL_HIDDEN and xproj.data_ptr() % 16:
        raise ValueError("the kernel copies xproj in 16-byte pieces: it must start "
                         "on a 16-byte boundary")
    all_h = torch.empty((T, B, H), dtype=out_dtype, device=xproj.device)
    _build.launch(_kernel_lib(), "drs_rnn_scan", xproj.device,
                  xproj.data_ptr(), w.data_ptr(), b.data_ptr(), _DTYPE_CODES[w.dtype],
                  None if h_init is None else h_init.data_ptr(),
                  None if lens is None else lens.data_ptr(),
                  all_h.data_ptr(), _DTYPE_CODES[out_dtype], T, B, H)
    _build.count_launch(rnn_scan)
    return all_h, all_h[-1]


rnn_scan.kernel_launches = 0


# ------------------------------------------------------- backward (K3b)

def rnn_scan_backward_reference(y: torch.Tensor, gh: torch.Tensor, h2h_w: torch.Tensor,
                                seq_lengths: torch.Tensor | None = None):
    """Plain PyTorch reverse scan (see ``csrc/rnn_scan_backward.cu``): the
    gradient ``dh`` of the state carried back in f32 from step T-1 to 0.

    Args:
      y: ``(T, B, H)`` f32 tanh values of the forward steps.
      gh: ``(T, B, H)`` f32 gradient of every step's output state.
      h2h_w: ``(H, H)`` recurrent weights, ``(in, out)``.
      seq_lengths: optional ``(B,)``; a frozen step passes ``dh`` on.

    Returns:
      ``(delta (T, B, H), dh0 (B, H))``, both f32: the gradient of each
      step's pre-activation (hence of ``xproj``) and of the initial state.
    """
    T, B, H = y.shape
    w_t = h2h_w.float().t()
    dh = torch.zeros((B, H), dtype=torch.float32, device=y.device)
    delta = torch.empty((T, B, H), dtype=torch.float32, device=y.device)
    for t in range(T - 1, -1, -1):
        g = dh + gh[t]
        d = (g + g * y[t]) * (1.0 - y[t])  # JAX's tanh VJP: g (1 + y)(1 - y)
        if seq_lengths is not None:
            alive = (t < seq_lengths.to(torch.int32))[:, None]
            d = torch.where(alive, d, 0.0)
            dh = torch.where(alive, d @ w_t, g)
        else:
            dh = d @ w_t
        delta[t] = d
    return delta, dh


def _declare_backward(lib: ctypes.CDLL):
    lib.drs_rnn_scan_backward.restype = ctypes.c_int
    lib.drs_rnn_scan_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # y, gh, w, w dtype
        ctypes.c_void_p,                                                    # seq_lengths
        ctypes.c_void_p, ctypes.c_void_p,                                   # delta, dh0
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                           # T, B, H
        ctypes.c_void_p,                                                    # stream
    ]


def rnn_scan_backward(y: torch.Tensor, gh: torch.Tensor, h2h_w: torch.Tensor,
                      seq_lengths: torch.Tensor | None = None):
    """The reverse scan of ``rnn_scan`` (the VJP of JAX's ``lax.scan``,
    ``ops/rnn.py:45-91``); arguments and results as
    ``rnn_scan_backward_reference``.

    CPU tensors take the plain loop. CUDA tensors launch K3b once, one
    block a batch row, and count the launch in
    ``rnn_scan_backward.kernel_launches``; a failed build or launch raises.
    """
    T, B, H = y.shape
    _check_hidden(H)
    if gh.shape != y.shape or h2h_w.shape != (H, H):
        raise ValueError(f"y and gh must be (T, B, H) and h2h_w (H, H); got "
                         f"{tuple(y.shape)}, {tuple(gh.shape)} and {tuple(h2h_w.shape)}")
    if y.dtype != torch.float32 or gh.dtype != torch.float32 or h2h_w.dtype not in _DTYPE_CODES:
        raise TypeError(f"y and gh must be float32 and h2h_w float32 or bfloat16; got "
                        f"{y.dtype}, {gh.dtype} and {h2h_w.dtype}")
    if seq_lengths is not None and (seq_lengths.shape != (B,) or seq_lengths.is_floating_point()):
        raise TypeError(f"seq_lengths must be an integer ({B},) tensor")
    if any(t is not None and t.device != y.device for t in (gh, h2h_w, seq_lengths)):
        raise ValueError("y, gh, h2h_w and seq_lengths must be on one device")
    if y.device.type == "cpu":
        return rnn_scan_backward_reference(y, gh, h2h_w, seq_lengths)
    if y.device.type != "cuda":
        raise ValueError(f"rnn_scan_backward runs on cpu or cuda, not {y.device}")
    delta = torch.empty((T, B, H), dtype=torch.float32, device=y.device)
    dh0 = torch.zeros((B, H), dtype=torch.float32, device=y.device)
    if T == 0 or B == 0:
        return delta, dh0
    # K3b copies y and gh and loads h2h_w in 16-byte words: a view that does
    # not start on a 16-byte boundary is copied first.
    y, gh, w = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (y, gh, h2h_w))
    lens = None if seq_lengths is None else seq_lengths.to(torch.int32).contiguous()
    _build.launch(_build.load("rnn_scan_backward", _declare_backward), "drs_rnn_scan_backward",
                  y.device, y.data_ptr(), gh.data_ptr(), w.data_ptr(), _DTYPE_CODES[w.dtype],
                  None if lens is None else lens.data_ptr(), delta.data_ptr(), dh0.data_ptr(),
                  T, B, H)
    _build.count_launch(rnn_scan_backward)
    return delta, dh0


rnn_scan_backward.kernel_launches = 0


class RnnScanFunction(torch.autograd.Function):
    """``rnn_scan``'s ``all_h`` differentiable with respect to ``xproj``,
    ``h2h_w``, ``h2h_b`` and ``h0``: forward K3 (the plain loop on the
    CPU), backward K3b (its plain loop on the CPU) for the gradients of
    ``xproj`` and ``h0``, then ``dW = sum_t h_{t-1}^T delta_t`` and
    ``db = sum_t delta_t`` as one product and one sum."""

    @staticmethod
    def forward(ctx, xproj, h2h_w, h2h_b, h0, seq_lengths, out_dtype):
        all_h, _ = _dispatch(xproj, h2h_w, h2h_b, out_dtype, h0, seq_lengths)
        ctx.save_for_backward(xproj, h2h_w, h2h_b, h0, seq_lengths, all_h)
        return all_h

    @staticmethod
    def backward(ctx, g_all):
        xproj, w, b, h0, lens, all_h = ctx.saved_tensors
        T, B, H = all_h.shape
        start = (torch.zeros((1, B, H), dtype=all_h.dtype, device=all_h.device) if h0 is None
                 else h0.to(all_h.dtype)[None])
        prev = torch.cat([start, all_h[:-1]]).float()  # h_{t-1}, as each step read it
        # The f32 tanh of every step, from the stored states (teacher-forced).
        y = torch.tanh((xproj + prev @ w.float()) + b.float())
        delta, dh0 = rnn_scan_backward(y, g_all.float(), w, lens)
        need = ctx.needs_input_grad
        dw = (prev.reshape(T * B, H).t() @ delta.reshape(T * B, H)).to(w.dtype) if need[1] else None
        db = delta.sum(dim=(0, 1)).to(b.dtype) if need[2] else None
        dh0 = dh0.to(h0.dtype) if h0 is not None and need[3] else None
        return delta if need[0] else None, dw, db, dh0, None, None


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
