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

On a mesh (``train.py::make_sharded_sparse_table_step``) each row shard of
the table takes ``sparse_adagrad_step_shard``: K5 with the ownership window
(the shard's fused rows ``[row_lo, row_lo + R_s)`` and its own
accumulator), over the stream of every data slice's ids, so that every
accumulator add still lands before any scale is read. A bf16 shard
follows the JAX sharded step (``train.py:177-182``): the accumulator still
takes one f32 add a slot, but the table's updates are summed a row in f32
and each touched row is rounded once (a merge inside K5's window: two
memsets zero the call's count of entries and free every key of its hash
table, launch 1 gives each touched row an entry of that table, launch 2
adds into the entry's f32 row, a last launch adds each row into the table,
rounds it and frees the entry). An f32 shard adds into its rows directly,
which is the same rule. A call's work does not depend on the calls before
it, so a CUDA graph can hold it: each call takes its scratch from the
caching allocator, a captured one from the graph's pool
(``_window_scratch``).

Any width d >= 1 computes: widths up to 64 whose rows (table and gradient)
are 16 * 2^k bytes take the vector instances, any other width K5's general
instance (a thread a slot, no vector adds), which is correct and not tuned.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.ops.embedding import _vector_row, scatter_counts, window_ids

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K5_THREADS = 256     # kThreads in csrc/sparse_adagrad.cu
K5_VEC_BYTES = 16    # Shipped::kVecBytes there: one lane's atomic add in launch 2


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """K5's two launches for ``n_bags`` bags (B * T) of L slots: launch 1
    (accumulate) on a lane a slot, ``lanes_per_bag`` lanes a window of a
    bag's slots, launch 2 (apply) on ``lanes_per_slot`` lanes a slot, each
    of ``K5_THREADS``-thread blocks. ``lanes_per_bag`` 0 is the general
    instance: a thread a slot in both launches."""
    lanes_per_bag: int
    lanes_per_slot: int
    accumulate_blocks: int
    apply_blocks: int

    @property
    def general(self) -> bool:
        return self.lanes_per_bag == 0


@functools.lru_cache(maxsize=None)  # the wrapper asks every step; host time counts
def k5_launch_plan(n_bags: int, L: int, d: int, table_dtype: torch.dtype,
                   g_dtype: torch.dtype = torch.float32) -> K5Plan:
    """Launch 1 takes the power of two >= L lanes a bag, at least a lane
    for each 16 bytes of the bag's gradient row and at most 32 (so short
    bags share a warp, and a longer bag takes a warp for each 32 of its
    slots); launch 2 takes a lane for each ``K5_VEC_BYTES`` of a table row,
    at most 32 lanes a slot. The C entry point gets ``lanes_per_bag`` and
    computes the same grids. Widths past 64, and a table or gradient row
    that is not 16 * 2^k bytes, take the general instance (a thread a
    slot, its mean g^2 summed in column order, ``csrc/sparse_adagrad.cu``)."""
    if not (d <= 64 and _vector_row(d * table_dtype.itemsize)
            and _vector_row(d * g_dtype.itemsize)):
        blocks = -(-n_bags * L // K5_THREADS)
        return K5Plan(0, 1, blocks, blocks)
    lanes_per_bag = min(32, max(1 << max(0, L - 1).bit_length(), d * g_dtype.itemsize // 16))
    windows = -(-L // lanes_per_bag)
    lanes_per_slot = min(32, d * table_dtype.itemsize // K5_VEC_BYTES)
    return K5Plan(lanes_per_bag, lanes_per_slot,
                  -(-n_bags * windows * lanes_per_bag // K5_THREADS),
                  -(-n_bags * L * lanes_per_slot // K5_THREADS))


@dataclasses.dataclass(frozen=True)
class K5WindowPlan:
    """K5's window: launch 1 on ``lanes_per_bag`` lanes a window of a
    bag's slots (a power of two <= 32), ``general`` at a width without the
    vector instances; launch 2 walks every slot of the stream."""
    lanes_per_bag: int
    general: bool


@functools.lru_cache(maxsize=None)
def k5_window_plan(n_bags: int, L: int, d: int, table_dtype: torch.dtype,
                   g_dtype: torch.dtype) -> K5WindowPlan:
    """The window's launch 1 takes ``k5_launch_plan``'s lanes a bag (the
    power of two >= L, at least a lane a 16-byte chunk of the gradient row,
    at most 32), or at the general instance's widths the power of two >= L
    (at most 32). A bag a task and a list of the owned slots for launch 2
    (``experiments/k5w_sweep.py``) measured slower (PERF.md §6)."""
    plan = k5_launch_plan(n_bags, L, d, table_dtype, g_dtype)
    lanes = plan.lanes_per_bag or min(32, 1 << max(0, L - 1).bit_length())
    return K5WindowPlan(lanes, plan.general)


def _window_rows(offsets, indices, g, window):
    """The step's touched rows (of the shard, with ``window``) and their
    f32 gradient rows; slots outside the window dropped."""
    B, T, L = indices.shape
    d = g.shape[-1]
    flat, valid = window_ids(offsets, indices, None, window)
    g_rows = g.float()[:, :, None, :].expand(B, T, L, d).reshape(B * T * L, d)
    if valid is not None:
        keep = valid.reshape(-1)
        flat, g_rows = flat[keep], g_rows[keep]
    return flat, g_rows


def sparse_adagrad_step_reference(table: torch.Tensor, acc: torch.Tensor,
                                  offsets: torch.Tensor, indices: torch.Tensor,
                                  g: torch.Tensor, learning_rate: float, eps: float = 1e-8,
                                  window: tuple[int, int] | None = None):
    """Plain PyTorch step: the JAX step's scatters as ``index_add_``, the
    accumulator's before the table's. With ``window = (row_lo, row_lo +
    R_s)`` (``window_ids``) ``table`` and ``acc`` are that row shard's and
    only the slots whose rows it owns take part."""
    flat, g_rows = _window_rows(offsets, indices, g, window)
    acc.index_add_(0, flat, torch.mean(g_rows * g_rows, dim=-1))
    scale = torch.rsqrt(acc[flat] + eps)
    update = -learning_rate * (g_rows * scale[:, None])
    if window is None or table.dtype == torch.float32:
        table.index_add_(0, flat, update.to(table.dtype))
        return
    # A shard of a narrower dtype: each touched row's updates summed in f32,
    # the row rounded once (the JAX sharded step, train.py:177-182).
    rows, rank = torch.unique(flat, return_inverse=True)
    summed = table.index_select(0, rows).float().index_add_(0, rank, update)
    table.index_copy_(0, rows, summed.to(table.dtype))


def _declare_window(lib: ctypes.CDLL):
    _declare(lib)
    lib.drs_sparse_adagrad_window.restype = ctypes.c_int
    lib.drs_sparse_adagrad_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # shard, table dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # acc (the shard's), g, g dtype
        ctypes.c_void_p, ctypes.c_void_p,              # offsets, indices
        ctypes.c_int64, ctypes.c_int64,                # row_lo, rows
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,    # B*T, T, L
        ctypes.c_float, ctypes.c_float,                # -learning_rate, eps
        ctypes.c_int, ctypes.c_int,                    # plan: lanes a bag, general
        ctypes.c_void_p,                               # merge: the count of entries
        ctypes.c_void_p, ctypes.c_int64,               # merge: hash keys, their number
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # merge: entries, claimed, f32 rows
        ctypes.c_void_p,                               # stream
    ]


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
    if table.dim() != 2 or table.shape[1] < 1 or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table must be (R, d) float32 or bfloat16 with d >= 1; "
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
    if (table.device.type == "cuda" and table.data_ptr() % 16
            and not k5_launch_plan(1, 1, d, table.dtype, g.dtype).general):
        raise ValueError("K5 adds 16-byte vectors into the table's rows: the table must "
                         "start on a 16-byte boundary")


def sparse_adagrad_step(table: torch.Tensor, acc: torch.Tensor, offsets: torch.Tensor,
                        indices: torch.Tensor, g: torch.Tensor, learning_rate: float,
                        eps: float = 1e-8):
    """One row-wise AdaGrad step of the rows ``indices`` read, in place.

    Args:
      table: fused ``(R, d)`` table, float32 or bfloat16, any d >= 1.
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
    _build.launch(_build.load("sparse_adagrad", _declare_window), "drs_sparse_adagrad",
                  table.device,
                  table.data_ptr(), _DTYPE_CODES[table.dtype], table.shape[1], acc.data_ptr(),
                  g.data_ptr(), _DTYPE_CODES[g.dtype], offsets.data_ptr(), indices.data_ptr(),
                  B * T, T, L, -learning_rate, eps, plan.lanes_per_bag)
    _build.count_launch(sparse_adagrad_step)
    return None


sparse_adagrad_step.kernel_launches = 0


def sparse_adagrad_step_shard(shard: torch.Tensor, acc_shard: torch.Tensor,
                              offsets: torch.Tensor, indices: torch.Tensor, g: torch.Tensor,
                              row_lo: int, learning_rate: float, eps: float = 1e-8):
    """One row-wise AdaGrad step of one row shard of the table, in place
    (K5 with the ownership window; the shard's masked scatters of the JAX
    sharded sparse step, ``train.py:177-182``).

    Args:
      shard: ``(R_s, d)`` rows ``[row_lo, row_lo + R_s)`` of the fused
        table, float32 or bfloat16, any d >= 1.
      acc_shard: its ``(R_s,)`` float32 accumulator.
      offsets, indices: the whole stream's table-local ids (every data
        slice's, concatenated in data-row order).
      g: ``(B, T, d)`` gradient of the stream's pooled outputs.
      row_lo, learning_rate, eps: the window's first fused row; the step's.

    Only the rows the shard owns are touched; a slot whose row another shard
    owns adds nothing. Every accumulator add lands before any scale is
    read. A bf16 shard's updates are summed a row in f32 and each touched
    row rounded once (the JAX sharded step's rule). CPU tensors take
    ``sparse_adagrad_step_reference(..., window=...)``; CUDA tensors launch
    K5's window (``_window_launch``: for a bf16 shard memsets of its count
    of entries and its hash keys, launch 1, which for a bf16 shard also
    gives each owned row its merge entry, launch 2, and for a bf16 shard the
    merge; counted once in ``sparse_adagrad_step_shard.kernel_launches``); a
    failed build or launch raises. A bf16 shard's scratch is the call's own
    (``_window_scratch``), so a CUDA graph can capture the call.
    """
    if row_lo < 0:
        raise ValueError(f"row_lo must be >= 0; got {row_lo}")
    _check(shard, acc_shard, offsets, indices, g)
    window = (row_lo, row_lo + shard.shape[0])
    if shard.device.type == "cpu":
        return sparse_adagrad_step_reference(shard, acc_shard, offsets, indices, g,
                                             learning_rate, eps, window=window)
    if shard.device.type != "cuda":
        raise ValueError(f"sparse_adagrad_step_shard runs on cpu or cuda, not {shard.device}")
    B, T, L = indices.shape
    if B * T == 0 or L == 0:
        return None
    plan = k5_window_plan(B * T, L, shard.shape[1], shard.dtype, g.dtype)
    _window_launch(shard, acc_shard, offsets, indices, g, row_lo, learning_rate, eps, plan)
    _build.count_launch(sparse_adagrad_step_shard)
    return None


sparse_adagrad_step_shard.kernel_launches = 0


def _window_launch(shard, acc, offsets, indices, g, row_lo: int, learning_rate: float,
                   eps: float, plan: K5WindowPlan, lib: ctypes.CDLL | None = None):
    """K5's window launches on checked CUDA tensors on ``plan``, with a
    bf16 shard's scratch (``_window_scratch``), from ``lib`` (a build of
    K5's source with its C entry; the shipped one by default)."""
    B, T, L = indices.shape
    n_slots = B * T * L
    if n_slots >= 2 ** 31:
        raise ValueError(f"K5's window indexes slots in int32; got {n_slots}")
    g = g.contiguous()
    if g.data_ptr() % 16:  # the kernels load g's rows in 16-byte chunks
        g = g.clone()
    dev = shard.device
    scratch = (None, None, 0, None, None, None)
    if shard.dtype != torch.float32:
        if shard.shape[0] >= 2 ** 31:
            raise ValueError(f"the bf16 window keys the shard's rows in int32; got "
                             f"{shard.shape[0]} rows")
        s = _window_scratch(dev, n_slots, shard.shape[1])
        work = s["work"].data_ptr()
        scratch = (s["count"].data_ptr(), s["keys"].data_ptr(), s["keys"].numel(), work,
                   work + 4 * n_slots, s["merged"].data_ptr())
    if lib is None:
        lib = _build.load("sparse_adagrad", _declare_window)
    _build.launch(lib, "drs_sparse_adagrad_window", dev, shard.data_ptr(),
                  _DTYPE_CODES[shard.dtype], shard.shape[1], acc.data_ptr(), g.data_ptr(),
                  _DTYPE_CODES[g.dtype], offsets.data_ptr(), indices.data_ptr(), row_lo,
                  shard.shape[0], B * T, T, L, -learning_rate, eps, plan.lanes_per_bag,
                  int(plan.general), *scratch)


def _window_scratch(device, n_slots: int, d: int) -> dict:
    """A bf16 window call's scratch, the call's own temporaries from the
    caching allocator (a captured call's from the graph's pool), none of
    which needs setting: ``count`` (one int32, which the call zeroes by a
    memset ahead of launch 1), ``work`` (int32: each slot's entry, then the
    claimed entries, ``n_slots`` each), ``keys`` (the hash table: int32, a
    power of two >= 2 ``n_slots``, so at most half full, which the call
    sets to -1 by a second memset) and ``merged`` (each key's f32 row of
    width ``d``, which the claiming slot zeroes). The allocator's stream
    semantics keep a call's scratch from a later call's until the first has
    run; nothing carries over from one call, or one replay, to the next."""
    n_keys = 1 << (2 * n_slots - 1).bit_length()
    return {"count": torch.empty((1,), dtype=torch.int32, device=device),
            "work": torch.empty((2 * n_slots,), dtype=torch.int32, device=device),
            "keys": torch.empty((n_keys,), dtype=torch.int32, device=device),
            "merged": torch.empty((n_keys, d), dtype=torch.float32, device=device)}


def sparse_adagrad_tolerance(table0: torch.Tensor, acc0: torch.Tensor, offsets: torch.Tensor,
                             indices: torch.Tensor, g: torch.Tensor, learning_rate: float,
                             eps: float = 1e-8, window: tuple[int, int] | None = None):
    """Elementwise bounds on |a - b| for the table and the accumulator after
    two steps from ``(table0, acc0)`` that differ only in the order of each
    row's adds. A row of n adds: the accumulator within n * 2^-22 * its
    sum of terms; each update term inherits that relative error through
    rsqrt (half of it), and each side rounds each add to the table dtype,
    so the updated rows agree within n * (2^-21 + 2 ulp) * (|table0| +
    sum |term|), ulp the table dtype's unit roundoff (2^-23 f32, 2^-8
    bf16). Where K5 runs its general instance (``k5_launch_plan``) the two
    sides also sum a bag's d squares in other orders: each mean within
    (d + 1) * 2^-23 of the other, relatively, which the accumulator adds
    and each term carries through rsqrt; so every row's terms differ, rows
    of one add too, and the cast of a term to a narrower table dtype can
    land an ulp of the term apart (2 ulp * sum |term| more; the vector
    instances keep torch.mean's order, so rows of one add cast the plain
    version's terms bit for bit). ``window``: two steps of that row
    shard (``table0``, ``acc0`` the shard's); a bf16 shard's rows follow
    the sharded rule (each row's updates summed in f32, the row rounded
    once), so its rows agree within the f32 bound above plus one bf16 ulp
    of the row's value."""
    d = g.shape[-1]
    R = table0.shape[0]
    flat, g_rows = _window_rows(offsets, indices, g, window)
    n = scatter_counts(offsets, indices, R, window=window)
    acc = acc0.clone().index_add_(0, flat, torch.mean(g_rows * g_rows, dim=-1))
    acc_tol = n * 2.0 ** -22 * acc
    mean_rel = 0.0
    if k5_launch_plan(1, 1, d, table0.dtype, g.dtype).general:
        mean_rel = (d + 1) * 2.0 ** -23
        acc_tol += mean_rel * (acc - acc0)
    scale = torch.rsqrt(acc[flat] + eps)[:, None]
    terms = learning_rate * g_rows.abs() * scale
    term_sum = torch.zeros((R, d), device=g.device).index_add_(0, flat, terms)
    once = window is not None and table0.dtype != torch.float32
    ulp = 2.0 ** -23 if table0.dtype == torch.float32 or once else 2.0 ** -8
    tol = n[:, None] * (2.0 ** -21 + 2 * ulp) * (table0.float().abs() + term_sum)
    tol += mean_rel * term_sum
    if mean_rel and not once and table0.dtype != torch.float32:
        tol += 2 * ulp * term_sum
    if once:
        value = table0.to(torch.float32, copy=True).index_add_(
            0, flat, -learning_rate * g_rows * scale)
        binade = torch.exp2(torch.floor(torch.log2((value.abs() + tol).clamp_min(2.0 ** -126))))
        tol += torch.where(n[:, None] > 0, binade * torch.finfo(table0.dtype).eps, 0.0)
    return tol, acc_tol
