"""The trainer's dense optimizer update: optax's sgd, adagrad and adam.

Counterpart of optax's ``update`` and ``apply_updates`` inside the JAX
package's jitted train step (``deeprecsys_tpu/train.py:362-363``, and the
sparse step's dense half, ``:255-256``), which XLA fuses into one pass a
leaf. ``optimizer_update`` is the dispatch: on CUDA tensors it launches the
hand-written Hopper kernel K10 (``csrc/optimizer_update.cu``: one pass that
reads each param, gradient and state element once and writes the param and
the state once, one launch for every leaf of one dtype), on CPU tensors it
runs the plain version ``optimizer_update_reference``, the same formulas as
eager ops. Both update the params and the state in place, where the JAX
step returns new arrays (its jit donates them).

The formulas are optax 0.2.6's (``make_optimizer``, JAX ``train.py:57-69``),
op by op in optax's order; the state has the params' dtype:

- sgd: p += -lr * g
- adagrad: acc = g^2 + acc (acc starts at 0.1); p += -lr * (g * rsqrt(acc +
  1e-7)). (optax's ``where(acc > 0, ...)`` is always true here: acc >= 0.1.)
- adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu;
  p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps), b1 0.9, b2 0.999, eps
  1e-8, the bias corrections bc = 1 - b^count in f32 (``adam_bias_corrections``),
  each cast to the leaf's dtype before it divides, as optax casts it.

adam's step count is an int32 scalar on the params' device, advanced in
place by ``Optimizer.update`` before the update reads it (optax's
``count``): a CUDA graph of the trainer's step then replays with the count
each replay reaches, where a host int would be frozen at its captured value.
"""

from __future__ import annotations

import ctypes

import torch

from deeprecsys_tpu_torch.ops import _build

OPTIMIZERS = ("sgd", "adagrad", "adam")
STATE_COUNTS = {"sgd": 0, "adagrad": 1, "adam": 2}  # state lists a leaf: (acc,), (mu, nu)
ADAGRAD_EPS = 1e-7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adam_bias_corrections(count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^count, 1 - b2^count)`` computed in f32 from the int32 step
    count, as optax does: f32 scalars on the count's device (``torch.pow``,
    whose f32 ``powf`` K10 also calls on the card)."""
    c = count.to(torch.float32)
    return tuple(1 - torch.pow(torch.full((), b, dtype=torch.float32, device=c.device), c)
                 for b in (ADAM_B1, ADAM_B2))


def _bias_corrected(m: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """``m / bc`` with ``bc`` cast to m's dtype first (optax's ``t /
    bias_correction.astype(t.dtype)``), divided in f32 and rounded to m's
    dtype: the same bits on the CPU and the card."""
    return (m.float() / bc.to(m.dtype).float()).to(m.dtype)


def optimizer_update_reference(name: str, params: list, grads: list, states: list,
                               learning_rate: float, count: torch.Tensor | None = None):
    """Plain PyTorch update, op by op in optax's order, in place.
    ``states``: ``[]`` (sgd), ``[accs]`` (adagrad), ``[mus, nus]`` (adam),
    each a list parallel to ``params``; ``count``: adam's step count, an
    int32 scalar tensor, already advanced for this step."""
    lr = learning_rate
    if name == "sgd":
        for p, g in zip(params, grads):
            p.add_(g * -lr)
    elif name == "adagrad":
        for p, g, acc in zip(params, grads, states[0]):
            acc.add_(g * g)
            u = (acc + ADAGRAD_EPS).rsqrt_()
            u.mul_(g).mul_(-lr)
            p.add_(u)
    elif name == "adam":
        b1, b2 = ADAM_B1, ADAM_B2
        bc1, bc2 = adam_bias_corrections(count)
        for p, g, mu, nu in zip(params, grads, states[0], states[1]):
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_((g * g) * (1 - b2))
            u = _bias_corrected(mu, bc1) / (torch.sqrt(_bias_corrected(nu, bc2)) + ADAM_EPS)
            p.add_(u * -lr)
    else:
        raise ValueError(f"unknown optimizer {name!r}")


def _declare(lib: ctypes.CDLL):
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.drs_optimizer_update.restype = ctypes.c_int
    lib.drs_optimizer_update.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,     # optimizer, dtype, leaves
        ptrs, ptrs, ptrs, ptrs,                       # p, g, s1, s2 (host arrays)
        ctypes.POINTER(ctypes.c_int64),               # elements a leaf
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # -lr, b1, 1 - b1
        ctypes.c_float, ctypes.c_float,               # b2, 1 - b2
        ctypes.c_float, ctypes.c_void_p,              # eps, adam's count (on the card)
        ctypes.c_void_p,                              # stream
    ]


def _check_count(name: str, count, device: torch.device):
    if name != "adam":
        return
    if not (isinstance(count, torch.Tensor) and count.shape == () and count.dtype == torch.int32
            and count.device == device):
        raise ValueError(f"adam takes its step count as an int32 scalar tensor on {device}; "
                         f"got {count!r}")


def _check(name: str, params: list, grads: list, states: list):
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    if len(states) != STATE_COUNTS[name]:
        raise ValueError(f"{name} takes {STATE_COUNTS[name]} state lists, got {len(states)}")
    if any(len(x) != len(params) for x in [grads, *states]):
        raise ValueError("params, grads and every state list must have one entry a leaf")
    if not params:
        return
    device = params[0].device
    for i, (p, g, *s) in enumerate(zip(params, grads, *states)):
        if p.dtype not in _DTYPE_CODES:
            raise ValueError(f"leaf {i}: params must be float32 or bfloat16, not {p.dtype}")
        for t, what in [(g, "grad"), *((x, "state") for x in s)]:
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"leaf {i}: {what} {tuple(t.shape)} {t.dtype} does not match "
                                 f"the param's {tuple(p.shape)} {p.dtype}")
        if any(t.device != device for t in (p, g, *s)):
            raise ValueError("every param, grad and state must be on one device")


def optimizer_update(name: str, params: list, grads: list, states: list,
                     learning_rate: float, count: torch.Tensor | None = None):
    """One step of optimizer ``name`` over every leaf, in place.

    Args:
      name: "sgd", "adagrad" or "adam".
      params: the leaves, float32 or bfloat16 tensors on one device.
      grads: their gradients, shape and dtype of each param.
      states: ``[]`` (sgd), ``[accs]`` (adagrad), ``[mus, nus]`` (adam),
        each a list of tensors of the params' shapes and dtypes.
      learning_rate: the step's.
      count: adam's step count, an int32 scalar tensor on the params'
        device, already advanced for this step (K10 reads it on the card);
        unused by sgd and adagrad.

    CPU tensors take ``optimizer_update_reference``. CUDA tensors launch K10
    (one launch for every leaf of one dtype, on the current stream) and
    count the call once in ``optimizer_update.kernel_launches``; the
    params and state must be contiguous (gradients are made so), and a
    failed build or launch raises. On the card K10 is bit for bit the plain
    version. Any other device raises.
    """
    _check(name, params, grads, states)
    if not params:
        return None
    device = params[0].device
    _check_count(name, count, device)
    if device.type == "cpu":
        return optimizer_update_reference(name, params, grads, states, learning_rate, count)
    if device.type != "cuda":
        raise ValueError(f"optimizer_update runs on cpu or cuda, not {device}")
    if not all(t.is_contiguous() for leaf in zip(params, *states) for t in leaf):
        raise ValueError("params and optimizer state must be contiguous")
    grads = [g.contiguous() for g in grads]
    hyper = (-learning_rate, ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2,
             ADAM_EPS if name == "adam" else ADAGRAD_EPS,
             count.data_ptr() if name == "adam" else None)
    lib = _build.load("optimizer_update", _declare)
    launched = False
    for dtype, code in _DTYPE_CODES.items():
        leaves = [i for i, p in enumerate(params) if p.dtype == dtype and p.numel()]
        if not leaves:
            continue
        launched = True
        n = len(leaves)

        def ptrs(ts):
            return (ctypes.c_void_p * n)(*[ts[i].data_ptr() if ts else None for i in leaves])

        state_ptrs = [ptrs(s) for s in states] + [ptrs(None)] * (2 - len(states))
        _build.launch(lib, "drs_optimizer_update", device, OPTIMIZERS.index(name), code, n,
                      ptrs(params), ptrs(grads), *state_ptrs,
                      (ctypes.c_int64 * n)(*[params[i].numel() for i in leaves]), *hyper)
    if launched:
        _build.count_launch(optimizer_update)
    return None


optimizer_update.kernel_launches = 0


class Optimizer:
    """One of optax's sgd, adagrad and adam (optax 0.2.6 defaults), applied
    in place by ``optimizer_update``: kernel K10 on the card, optax's update
    written out op by op on the CPU (the formulas are above). The state
    mirrors the params in their dtype, as optax's does: adagrad a list of
    accumulators (starting at 0.1), adam ``{"count", "mu", "nu"}`` with the
    count an int32 scalar on the params' device, advanced in place. The
    single-device trainer and the mesh trainers (``parallel/sharding.py::
    MeshOptimizer``) both take it.
    """

    def __init__(self, name: str, learning_rate: float):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.lr = name, learning_rate

    def init(self, leaves: list):
        if self.name == "adagrad":
            return [torch.full_like(p, 0.1) for p in leaves]
        if self.name == "adam":
            device = leaves[0].device if leaves else torch.device("cpu")
            return {"count": torch.zeros((), dtype=torch.int32, device=device),
                    "mu": [torch.zeros_like(p) for p in leaves],
                    "nu": [torch.zeros_like(p) for p in leaves]}
        return None

    @torch.no_grad()
    def update(self, leaves: list, grads, state):
        if self.name == "sgd":
            optimizer_update("sgd", leaves, grads, [], self.lr)
        elif self.name == "adagrad":
            optimizer_update("adagrad", leaves, grads, [state], self.lr)
        else:
            state["count"].add_(1)
            optimizer_update("adam", leaves, grads, [state["mu"], state["nu"]], self.lr,
                             count=state["count"])
        return state
