"""Sparse row-wise AdaGrad step of the fused embedding table.

Counterpart of the sparse half of ``deeprecsys_tpu/train.py::
make_sparse_table_step`` (:258-278). The table is updated only in the rows
a batch looked up, each bag's pooled-output gradient broadcast over its L
rows, with one f32 accumulator a row:

    acc[flat]   += mean(g_rows^2)              (every add lands first)
    table[flat] += cast(-lr * g_rows * rsqrt(acc[flat] + eps))

Duplicate rows each add their own g^2 and their own update.
``sparse_adagrad_step`` is the dispatch: on CUDA tensors it launches the
hand-written Hopper kernel K5 (``csrc/sparse_adagrad.cu``, two launches:
accumulate, with ``k5_launch_plan``'s lanes a bag; then apply, 16-byte
vector atomic adds into each touched row, started early by programmatic
dependent launch), on CPU tensors it runs the plain version
``sparse_adagrad_step_reference``. Both update ``table`` and ``acc`` in
place, where the JAX step returns new arrays (its jit donates them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.ops.embedding import scatter_counts

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_WIDTHS = (32, 64)
K5_THREADS = 256     # kThreads in csrc/sparse_adagrad.cu
K5_VEC_BYTES = 16    # Shipped::kVecBytes there: one lane's atomic add in launch 2


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """K5's two launches for ``n_bags`` bags (B * T) of L slots: launch 1
    (accumulate) on a lane a slot, ``lanes_per_bag`` lanes a window of a
    bag's slots, launch 2 (apply) on ``lanes_per_slot`` lanes a slot, each
    of ``K5_THREADS``-thread blocks."""
    lanes_per_bag: int
    lanes_per_slot: int
    accumulate_blocks: int
    apply_blocks: int


@functools.lru_cache(maxsize=None)  # the wrapper asks every step; host time counts
def k5_launch_plan(n_bags: int, L: int, d: int, table_dtype: torch.dtype,
                   g_dtype: torch.dtype = torch.float32) -> K5Plan:
    """Launch 1 takes the power of two >= L lanes a bag, at least a lane
    for each 16 bytes of the bag's gradient row and at most 32 (so short
    bags share a warp, and a longer bag takes a warp for each 32 of its
    slots); launch 2 takes a lane for each ``K5_VEC_BYTES`` of a table row,
    at most 32 lanes a slot. The C entry point gets ``lanes_per_bag`` and
    computes the same grids."""
    lanes_per_bag = min(32, max(1 << max(0, L - 1).bit_length(), d * g_dtype.itemsize // 16))
    windows = -(-L // lanes_per_bag)
    lanes_per_slot = min(32, d * table_dtype.itemsize // K5_VEC_BYTES)
    return K5Plan(lanes_per_bag, lanes_per_slot,
                  -(-n_bags * windows * lanes_per_bag // K5_THREADS),
                  -(-n_bags * L * lanes_per_slot // K5_THREADS))


def sparse_adagrad_step_reference(table: torch.Tensor, acc: torch.Tensor,
                                  offsets: torch.Tensor, indices: torch.Tensor,
                                  g: torch.Tensor, learning_rate: float, eps: float = 1e-8):
    """Plain PyTorch step: the JAX step's scatters as ``index_add_``, the
    accumulator's before the table's."""
    B, T, L = indices.shape
    d = g.shape[-1]
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    g_rows = g.float()[:, :, None, :].expand(B, T, L, d).reshape(B * T * L, d)
    acc.index_add_(0, flat, torch.mean(g_rows * g_rows, dim=-1))
    scale = torch.rsqrt(acc[flat] + eps)
    table.index_add_(0, flat, (-learning_rate * (g_rows * scale[:, None])).to(table.dtype))


def _declare(lib: ctypes.CDLL):
    lib.drs_sparse_adagrad.restype = ctypes.c_int
    lib.drs_sparse_adagrad.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # table, table dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # acc, g, g dtype
        ctypes.c_void_p, ctypes.c_void_p,              # offsets, indices
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,    # B*T, T, L
        ctypes.c_float, ctypes.c_float,                # -learning_rate, eps
        ctypes.c_int, ctypes.c_void_p,                 # lanes a bag, stream
    ]


def _check(table, acc, offsets, indices, g):
    if table.dim() != 2 or table.shape[1] not in _KERNEL_WIDTHS or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table must be (R, d) float32 or bfloat16 with d in {_KERNEL_WIDTHS}; "
                         f"got {tuple(table.shape)} {table.dtype}")
    R, d = table.shape
    if acc.shape != (R,) or acc.dtype != torch.float32:
        raise ValueError(f"acc must be ({R},) float32; got {tuple(acc.shape)} {acc.dtype}")
    if indices.dim() != 3 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be (B, T, L) int32; got {tuple(indices.shape)} "
                        f"{indices.dtype}")
    B, T, _ = indices.shape
    if offsets.shape != (T,) or offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be ({T},) int32; got {tuple(offsets.shape)} {offsets.dtype}")
    if g.shape != (B, T, d) or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"g must be ({B}, {T}, {d}) float32 or bfloat16; got "
                         f"{tuple(g.shape)} {g.dtype}")
    if any(t.device != table.device for t in (acc, offsets, indices, g)):
        raise ValueError("table, acc, offsets, indices and g must be on one device")
    if not all(t.is_contiguous() for t in (table, acc, offsets, indices)):
        raise ValueError("table, acc, offsets and indices must be contiguous")
    if table.device.type == "cuda" and table.data_ptr() % 16:
        raise ValueError("K5 adds 16-byte vectors into the table's rows: the table must "
                         "start on a 16-byte boundary")


def sparse_adagrad_step(table: torch.Tensor, acc: torch.Tensor, offsets: torch.Tensor,
                        indices: torch.Tensor, g: torch.Tensor, learning_rate: float,
                        eps: float = 1e-8):
    """One row-wise AdaGrad step of the rows ``indices`` read, in place.

    Args:
      table: fused ``(R, d)`` table, float32 or bfloat16, d 32 or 64.
      acc: ``(R,)`` float32 accumulator, one a row.
      offsets, indices: as ``embedding_bag`` took them (ids not checked).
      g: ``(B, T, d)`` gradient of the pooled output, float32 or bfloat16.
      learning_rate, eps: the step's; the update is cast to the table dtype
        before it is added.

    CPU tensors take ``sparse_adagrad_step_reference``. CUDA tensors launch
    K5 (two kernels on the current stream, ``k5_launch_plan``) and count
    the call once in ``sparse_adagrad_step.kernel_launches``; a failed build
    or launch raises. The kernel's atomic adds run in no fixed order, so
    rows that repeat within a batch agree with the plain version to within
    the rounding of their adds.
    """
    _check(table, acc, offsets, indices, g)
    if table.device.type == "cpu":
        return sparse_adagrad_step_reference(table, acc, offsets, indices, g,
                                             learning_rate, eps)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_adagrad_step runs on cpu or cuda, not {table.device}")
    B, T, L = indices.shape
    if B * T == 0 or L == 0:
        return None
    g = g.contiguous()
    if g.data_ptr() % 16:  # the kernels load g's rows in 16-byte chunks
        g = g.clone()
    plan = k5_launch_plan(B * T, L, table.shape[1], table.dtype, g.dtype)
    _build.launch(_build.load("sparse_adagrad", _declare), "drs_sparse_adagrad", table.device,
                  table.data_ptr(), _DTYPE_CODES[table.dtype], table.shape[1], acc.data_ptr(),
                  g.data_ptr(), _DTYPE_CODES[g.dtype], offsets.data_ptr(), indices.data_ptr(),
                  B * T, T, L, -learning_rate, eps, plan.lanes_per_bag)
    _build.count_launch(sparse_adagrad_step)
    return None


sparse_adagrad_step.kernel_launches = 0


def sparse_adagrad_tolerance(table0: torch.Tensor, acc0: torch.Tensor, offsets: torch.Tensor,
                             indices: torch.Tensor, g: torch.Tensor, learning_rate: float,
                             eps: float = 1e-8):
    """Elementwise bounds on |a - b| for the table and the accumulator after
    two steps from ``(table0, acc0)`` that differ only in the order of each
    row's adds. A row of n adds: the accumulator within n * 2^-22 * its
    sum of terms; each update term inherits that relative error through
    rsqrt (half of it), and each side rounds each add to the table dtype,
    so the updated rows agree within n * (2^-21 + 2 ulp) * (|table0| +
    sum |term|), ulp the table dtype's unit roundoff (2^-23 f32, 2^-8
    bf16)."""
    B, T, L = indices.shape
    d = g.shape[-1]
    R = table0.shape[0]
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    g_rows = g.float()[:, :, None, :].expand(B, T, L, d).reshape(-1, d)
    n = scatter_counts(offsets, indices, R)
    acc = acc0.clone().index_add_(0, flat, torch.mean(g_rows * g_rows, dim=-1))
    acc_tol = n * 2.0 ** -22 * acc
    terms = (learning_rate * g_rows.abs() * torch.rsqrt(acc[flat] + eps)[:, None])
    term_sum = torch.zeros((R, d), device=g.device).index_add_(0, flat, terms)
    ulp = 2.0 ** -23 if table0.dtype == torch.float32 else 2.0 ** -8
    tol = n[:, None] * (2.0 ** -21 + 2 * ulp) * (table0.float().abs() + term_sum)
    return tol, acc_tol
