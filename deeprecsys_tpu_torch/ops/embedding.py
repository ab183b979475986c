"""Fused multi-table pooled embedding lookup.

Counterpart of ``deeprecsys_tpu/ops/embedding.py`` (:40-73, :129-134,
:770-800). All of a model's tables live in one ``(total_rows, d)`` tensor
with per-table row offsets, and the model's whole sparse lookup is one
fused gather + sum over the pooling axis:

    indices (B, T, L) int32  --(+offsets)-->  rows (B*T*L, d)  --sum L-->  (B, T, d)

``embedding_bag`` is the dispatch: on a CUDA tensor it launches the
hand-written Hopper kernel K1 (``csrc/embedding_bag.cu``), on a CPU tensor
it runs the plain version ``embedding_bag_reference``. The port keeps only
the unpacked layout; packed TPU checkpoints are unpacked by ``bridge``.

Under autograd (grad enabled and a table that requires grad, as in the
dense trainer) the lookup runs as ``EmbeddingBagFunction``: its forward is
the same dispatch, its backward ``embedding_bag_backward``, kernel K1b
(``csrc/embedding_bag_backward.cu``) on the card and the ``index_add_`` of
``embedding_bag_backward_reference`` on the CPU. Inference and serving
(``inference_mode``, tables without grad) call the dispatch directly.

Quantized tables (JAX ``ops/embedding.py:76-102, :211-284``,
``models/base.py:163-182``) take two more dispatches of the same shape:

- ``embedding_bag_int8``: per-table int8, ``q (R, d)`` int8 and ``scale
  (T,)`` f32; each bag pooled in exact int32, then one f32 multiply by its
  table's scale and a cast to the compute dtype. Kernel K1-int8
  (``csrc/embedding_bag_int8.cu``); the same bits as the JAX op.
- ``embedding_bag_int8_rowwise``: ``(R, d + 4)`` int8 rows whose last 4
  bytes are the row's f32 scale (``dequant_packed_rows``); each element
  dequantized by one f32 multiply, summed over L in f32, cast once. Kernel
  K4 (same source).

The JAX package may store per-table int8 packed (``q_packed``);
``bridge.params_from_numpy`` unpacks it, so the port only sees ``(R, d)``.

On a mesh (``parallel/sharding.py``) each row shard of a table pools its
own partial: ``embedding_bag_shard``, ``embedding_bag_int8_shard`` and
``embedding_bag_int8_rowwise_shard`` launch the same kernels with an
ownership window (the shard's fused rows ``[row_lo, row_hi)``; a slot whose
row lies outside adds nothing) and return the sum before its last step (f32
for float and row-wise tables, the exact int32 pool for per-table int8), and
the ``*_hotcold_*_shard`` wrappers do the same for K6 on a shard's cold
stream. The caller adds the shards' partials and then scales and rounds
once, so a sharded per-table int8 lookup is bit for bit the single-device
one. Each keeps its own launch count.

The export helpers ``quantize_rowwise_int8`` and ``quantize_pertable_int8``
are plain torch: they run once an export. (JAX's ``pack_table`` is
``bridge._pack``: the port packs rows only to write the JAX package's file
layouts.)
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from deeprecsys_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_WIDTHS = (32, 64)


def init_fused_tables(table_rows, dim: int, dtype: torch.dtype,
                      generator: torch.Generator,
                      device: torch.device | str) -> torch.Tensor:
    """The fused ``(sum(table_rows), dim)`` table, each table drawn from
    U(-sqrt(1/n), sqrt(1/n)) (reference ``dlrm_s_caffe2.py:295-300``).

    Values are drawn in f32, scaled and cast per table, so the f32
    scratch is one table, not the whole fused array.
    """
    table_rows = np.asarray(table_rows, dtype=np.int64)
    bounds = np.sqrt(1.0 / table_rows).astype(np.float32)
    out = torch.empty((int(table_rows.sum()), dim), dtype=dtype, device=device)
    start = 0
    for n, bound in zip(table_rows.tolist(), bounds.tolist()):
        u = torch.empty((n, dim), dtype=torch.float32, device=device)
        u.uniform_(-1.0, 1.0, generator=generator)
        out[start:start + n] = (u * bound).to(dtype)
        start += n
    return out


def int8_table_scales(table_rows) -> np.ndarray:
    """The ``(T,)`` f32 scales of the int8 inits: f32(sqrt(1/n)) / 127,
    divided in f32 (JAX ``ops/embedding.py:91-92, :246``), so that the
    init's U(+-sqrt(1/n)) bound is q = 127."""
    bounds = np.sqrt(1.0 / np.asarray(table_rows, dtype=np.int64)).astype(np.float32)
    return bounds / np.float32(127.0)


def _draw_int8(n: int, dim: int, generator: torch.Generator, device) -> torch.Tensor:
    """``(n, dim)`` int8 values drawn uniformly from [-127, 127]."""
    return torch.randint(-127, 128, (n, dim), generator=generator, device=device,
                         dtype=torch.int8)


def init_fused_tables_int8(table_rows, dim: int, generator: torch.Generator,
                           device: torch.device | str) -> dict:
    """Per-table int8 fused tables, ``{"q": (R, dim) int8, "scale": (T,)
    f32}``: values on the int8 grid, drawn a table at a time, at the
    scale that makes the reference's U(-sqrt(1/n), sqrt(1/n)) init exact
    (JAX ``init_fused_tables_int8``; the port keeps the unpacked layout)."""
    table_rows = [int(n) for n in table_rows]
    q = torch.empty((sum(table_rows), dim), dtype=torch.int8, device=device)
    start = 0
    for n in table_rows:
        q[start:start + n] = _draw_int8(n, dim, generator, device)
        start += n
    return {"q": q, "scale": torch.from_numpy(int8_table_scales(table_rows)).to(device)}


def init_fused_tables_int8_rowwise(table_rows, dim: int, generator: torch.Generator,
                                   device: torch.device | str) -> torch.Tensor:
    """Row-wise int8 fused tables, ``(R, dim + 4)`` int8: values on the
    int8 grid and, in the last 4 bytes of each row, its table's scale as
    little-endian f32 bytes (JAX ``init_fused_tables_int8_rowwise``)."""
    table_rows = [int(n) for n in table_rows]
    out = torch.empty((sum(table_rows), dim + 4), dtype=torch.int8, device=device)
    start = 0
    for n, s in zip(table_rows, int8_table_scales(table_rows).tolist()):
        out[start:start + n, :dim] = _draw_int8(n, dim, generator, device)
        scale = torch.full((n,), s, dtype=torch.float32, device=device)
        out[start:start + n, dim:] = scale.view(torch.int8).reshape(n, 4)
        start += n
    return out


def unpack_table(table_packed: torch.Tensor, pack: int, total_rows: int) -> torch.Tensor:
    """Logical ``(total_rows, d)`` view of a ``(ceil(R/pack), pack*d)``
    packed table (inverse of the JAX package's ``pack_table``)."""
    if pack <= 1:
        return table_packed
    d = table_packed.shape[1] // pack
    return table_packed.reshape(-1, d)[:total_rows]


def window_ids(offsets: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor | None,
               window: tuple[int, int] | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The rows a lookup reads and which slots count: ``(B*T*L,)`` int64
    rows of the table it is given, and a ``(B, T, L)`` bool of the slots
    that add (None: all). With ``window = (row_lo, row_hi)`` the table is
    that row shard of the fused table: a slot adds iff its fused row lies in
    ``[row_lo, row_hi)``, and reads shard row ``fused - row_lo`` (row 0 for
    the others, masked out); JAX ``parallel/sharding.py:102-130``."""
    flat = indices.long() + offsets.long()[None, :, None]
    if window is None:
        return flat.reshape(-1), mask
    row_lo, row_hi = window
    valid = (flat >= row_lo) & (flat < row_hi)
    if mask is not None:
        valid &= mask
    return torch.where(valid, flat - row_lo, 0).reshape(-1), valid


def embedding_bag_reference(table: torch.Tensor, offsets: torch.Tensor,
                            indices: torch.Tensor, *,
                            compute_dtype: torch.dtype | None = None,
                            mask: torch.Tensor | None = None,
                            window: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch pooled lookup: each gathered row converted to the
    compute dtype, summed over L in f32 and rounded once (the JAX op's
    numerics: a bf16 ``jnp.sum`` accumulates in f32). Masked-out slots
    contribute zero. With ``window`` (``window_ids``) ``table`` is a row
    shard and the result is its f32 partial, not rounded."""
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    B, T, L = indices.shape
    flat, mask = window_ids(offsets, indices, mask, window)
    rows = table.index_select(0, flat).to(cdt).float().reshape(B, T, L, -1)
    if mask is not None:
        rows = torch.where(mask[..., None], rows, 0.0)
    pooled = rows.sum(dim=2)
    return pooled if window is not None else pooled.to(cdt)


def pooled_tolerance(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                     offsets: torch.Tensor, indices: torch.Tensor,
                     mask: torch.Tensor | None = None,
                     window: tuple[int, int] | None = None) -> torch.Tensor:
    """Elementwise bound on |a - b| for two pooled outputs of this op that
    differ only in the order of their f32 sums: L * 2^-23 * sum|rows|
    (recursive summation error, both orders together), plus one bf16 ulp of
    the larger value when the outputs are bf16 (each side rounds once).
    ``window``: two f32 partials of a row shard."""
    abs_sum = embedding_bag_reference(table.abs(), offsets, indices,
                                      compute_dtype=torch.float32, mask=mask, window=window)
    return _order_tolerance(a, b, abs_sum, indices.shape[-1])


def _order_tolerance(a, b, abs_sum: torch.Tensor, L: int) -> torch.Tensor:
    """``pooled_tolerance``'s bound from the pooled sum of |rows|."""
    tol = L * 2.0 ** -23 * abs_sum
    if a.dtype == torch.bfloat16:
        big = torch.maximum(a.float().abs(), b.float().abs())
        big = torch.clamp(big, min=torch.finfo(torch.float32).tiny)
        tol = tol + torch.exp2(torch.floor(torch.log2(big)) - 7)
    return tol


# K1's launch geometry, mirroring kWarpsPerBlock and kMinBlocksPerSm in
# csrc/embedding_bag.cu (its __launch_bounds__ keeps K1_BLOCKS_PER_SM
# blocks an SM resident).
K1_WARPS_PER_BLOCK = 8
K1_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """How K1 maps bags onto the card (see ``csrc/embedding_bag.cu``).

    A warp pools ``bags_per_warp`` bags at once (a task); each of a bag's
    ``row_slots // bags_per_warp`` slots of lanes issues ``rows_per_lane``
    independent row loads a step. ``grid`` blocks of K1_WARPS_PER_BLOCK
    warps walk the ``tasks`` in a grid-stride loop (one task a warp when the
    grid covers them all, as ``k1_launch_plan``'s does).
    """

    bags_per_warp: int
    rows_per_lane: int
    row_slots: int
    tasks: int
    grid: int

    @property
    def rows_per_step(self) -> int:
        """Rows of one bag a warp reads a step."""
        return self.row_slots // self.bags_per_warp * self.rows_per_lane


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _plan(n_bags: int, L: int, S: int, long_rows_per_lane: int,
          short_rows_per_lane: int = 8, long_bags_per_warp: int = 1) -> K1Plan:
    """A slot a bag for L <= 8, with all L rows in flight (the power of two
    >= L, at most ``short_rows_per_lane``); else ``long_bags_per_warp``
    bags a warp and ``long_rows_per_lane`` rows a slot a step."""
    G, U = ((S, min(_pow2_at_least(max(L, 1)), short_rows_per_lane)) if L <= 8
            else (long_bags_per_warp, long_rows_per_lane))
    tasks = -(-n_bags // G)
    grid = max(1, -(-tasks // K1_WARPS_PER_BLOCK))
    return K1Plan(bags_per_warp=G, rows_per_lane=U, row_slots=S, tasks=tasks, grid=grid)


@functools.lru_cache(maxsize=512)
def k1_launch_plan(n_bags: int, L: int, d: int, table_dtype: torch.dtype) -> K1Plan:
    """K1's mapping for ``n_bags = B * T`` bags of ``L`` rows of width ``d``.

    A lane loads 16 bytes, so a row takes ``d * itemsize / 16`` lanes and a
    warp has ``S = 32 / that`` row slots (8 for bf16 d = 32). For L <= 8
    every slot is its own bag (``S`` bags a warp) and loads all L rows at
    once (U = the power of two >= L, at most 8). Longer bags take a warp
    each, U = 4 rows a slot a step: of the mappings measured on an H100,
    the fastest at rm1 and rm3 (fewer registers than U = 8 keep more warps
    resident), and within the run-to-run spread at rm2 (PERF.md). The grid
    is one block per K1_WARPS_PER_BLOCK tasks: capping it at the blocks the
    card holds at once, each block looping over tasks, measured no faster.
    These are the only mappings ``csrc/embedding_bag.cu`` is built with.

    K1-int8 (``csrc/embedding_bag_int8.cu``) takes ``table_dtype=torch.int8``:
    16 int8 values a lane too (S = 16 at d = 32, 8 at d = 64), one slot a
    bag and at most 2 rows a step for L <= 8; longer bags a warp each and
    U = 2 at d = 32, 4 a warp (2 slots each) and U = 4 at d = 64: of the
    mappings measured on an H100 (``experiments/int8_sweep.py``, PERF.md),
    the fastest at the zoo's shapes on uniform and zipf(1.2) ids, and the
    only ones that source builds.
    """
    if table_dtype == torch.int8:
        return _plan(n_bags, L, 512 // d, 2 if d == 32 else 4, 2, 1 if d == 32 else 4)
    return _plan(n_bags, L, 32 // (d * table_dtype.itemsize // 16), 4)


@functools.lru_cache(maxsize=512)
def k4_launch_plan(n_bags: int, L: int, d: int) -> K1Plan:
    """K4's mapping for ``(R, d + 4)`` int8 rows, whose lanes each load the
    16-byte-aligned chunks that cover their part of a row (rows start on
    4-byte boundaries only). Bags of one row take a slot each at 8 values a
    lane (S = 256 / d slots a warp); bags of 2-8 rows a slot each at 16
    values a lane (S = 512 / d), 2 rows a step; longer bags 16 values a
    lane, a warp a bag and 2 rows a slot a step at d = 32, 4 bags a warp
    and 3 rows at d = 64. Chosen by measurement on an H100
    (``experiments/int8_sweep.py``, PERF.md): at L = 1 the narrower lanes
    spread a batch over twice the warps and finish sooner. The only
    mappings ``csrc/embedding_bag_int8.cu`` builds for K4."""
    return _plan(n_bags, L, 256 // d if L <= 1 else 512 // d, 2 if d == 32 else 3, 2,
                 1 if d == 32 else 4)


def _declare(lib: ctypes.CDLL):
    lib.drs_embedding_bag.restype = ctypes.c_int
    lib.drs_embedding_bag.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,       # table, dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
        ctypes.c_void_p, ctypes.c_int,                      # out, out dtype
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: bags/warp, rows/lane, grid
        ctypes.c_void_p,                                    # stream
    ]
    lib.drs_embedding_bag_window.restype = ctypes.c_int
    lib.drs_embedding_bag_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,       # shard, dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
        ctypes.c_void_p, ctypes.c_int,                      # out (f32), compute dtype
        ctypes.c_int64, ctypes.c_int64,                     # row_lo, rows of the shard
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: bags/warp, rows/lane, grid
        ctypes.c_void_p,                                    # stream
    ]


def _kernel_lib() -> ctypes.CDLL:
    return _build.load("embedding_bag", _declare)


def _check(table, offsets, indices, cdt, mask):
    """Raise on anything the kernel does not take (both devices share the
    contract, so the CPU tests exercise these checks too)."""
    _check_float_table(table, cdt)
    _check_ids(table, offsets, indices, mask)


def _check_float_table(table, cdt):
    if table.dim() != 2 or table.shape[1] not in _KERNEL_WIDTHS:
        raise ValueError(f"table must be (R, d) with d in {_KERNEL_WIDTHS}; "
                         f"got {tuple(table.shape)}")
    if table.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES:
        raise TypeError(f"table and compute dtypes must be float32 or bfloat16; "
                        f"got {table.dtype} and {cdt}")


def _check_ids(table, offsets, indices, mask, *others):
    """The ids, offsets and mask of a lookup into ``table``; every tensor
    on the table's device and contiguous (``others`` too)."""
    if indices.dim() != 3 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be (B, T, L) int32; got "
                        f"{tuple(indices.shape)} {indices.dtype}")
    if offsets.shape != (indices.shape[1],) or offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be ({indices.shape[1]},) int32; got "
                        f"{tuple(offsets.shape)} {offsets.dtype}")
    if mask is not None and (mask.shape != indices.shape or mask.dtype != torch.bool):
        raise TypeError(f"mask must be bool of shape {tuple(indices.shape)}; got "
                        f"{tuple(mask.shape)} {mask.dtype}")
    device = table.device
    if offsets.device != device or indices.device != device or (
            mask is not None and mask.device != device) or any(
            t.device != device for t in others):
        raise ValueError("table, offsets, indices and mask must be on one device")
    if not (table.is_contiguous() and offsets.is_contiguous() and indices.is_contiguous()
            and (mask is None or mask.is_contiguous())
            and all(t.is_contiguous() for t in others)):
        raise ValueError("table, offsets, indices and mask must be contiguous")


def embedding_bag(table: torch.Tensor, offsets: torch.Tensor,
                  indices: torch.Tensor, *,
                  compute_dtype: torch.dtype | None = None,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled multi-table lookup (JAX ``ops/embedding.py:770-800``).

    Args:
      table: fused ``(total_rows, d)`` table, float32 or bfloat16, d 32 or 64.
      offsets: ``(T,)`` int32 first row of each table.
      indices: ``(B, T, L)`` int32 table-local ids, ``0 <= id < rows[t]``.
        The kernel does not check the range. The JAX gather adds the
        table's offset first, so an id just past its own table reads the
        next table's row, and only an id past the whole fused table gives
        NaN (ROADMAP.md Queue 3, deliberate differences).
      mask: optional ``(B, T, L)`` bool; masked-out slots contribute zero.

    Returns:
      ``(B, T, d)`` pooled rows in ``compute_dtype`` (default: the table's).

    CPU tensors take ``embedding_bag_reference``. CUDA tensors launch K1
    with ``k1_launch_plan``'s mapping and count the launch in
    ``embedding_bag.kernel_launches``; a failed build or launch raises.
    With grad enabled and ``table.requires_grad`` the call is differentiable
    with respect to the table (``EmbeddingBagFunction``).
    """
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    _check(table, offsets, indices, cdt, mask)
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBagFunction.apply(table, offsets, indices, mask, cdt)
    return _dispatch(table, offsets, indices, mask, cdt)


def _dispatch(table, offsets, indices, mask, cdt) -> torch.Tensor:
    """The plain version on the CPU, K1 on the card (checked inputs)."""
    device = table.device
    if device.type == "cpu":
        return embedding_bag_reference(table, offsets, indices,
                                       compute_dtype=cdt, mask=mask)
    if device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda, not {device}")
    if table.data_ptr() % 16:
        raise ValueError("the kernel loads 16-byte vectors: the table must "
                         "start on a 16-byte boundary")
    B, T, L = indices.shape
    return _launch(table, offsets, indices, mask, cdt,
                   k1_launch_plan(B * T, L, table.shape[1], table.dtype))


def _launch(table, offsets, indices, mask, cdt, plan: K1Plan) -> torch.Tensor:
    """K1 with ``plan``'s mapping, on checked CUDA inputs."""
    B, T, L = indices.shape
    d = table.shape[1]
    out = torch.empty((B, T, d), dtype=cdt, device=table.device)
    if B * T == 0:
        return out
    _build.launch(_kernel_lib(), "drs_embedding_bag", table.device,
                  table.data_ptr(), _DTYPE_CODES[table.dtype], d,
                  offsets.data_ptr(), indices.data_ptr(),
                  mask.data_ptr() if mask is not None else None,
                  out.data_ptr(), _DTYPE_CODES[cdt], B * T, T, L,
                  plan.bags_per_warp, plan.rows_per_lane, plan.grid)
    _build.count_launch(embedding_bag)
    return out


embedding_bag.kernel_launches = 0


# ------------------------------------------------------- backward (K1b)

K1B_WARPS_PER_BLOCK = 8  # kWarpsPerBlock in csrc/embedding_bag_backward.cu


def embedding_bag_backward_reference(g: torch.Tensor, offsets: torch.Tensor,
                                     indices: torch.Tensor, num_rows: int, *,
                                     mask: torch.Tensor | None = None,
                                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch gradient of the pooled lookup with respect to the
    table: each bag's pooled gradient, broadcast over its L slots in f32
    (zero where masked out), ``index_add_``-ed into the rows the bag read.
    Accumulates into ``out`` (f32 ``(num_rows, d)``) if given, else into
    zeros; returns the f32 sum."""
    B, T, L = indices.shape
    d = g.shape[-1]
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    rows = g.float()[:, :, None, :].expand(B, T, L, d)
    if mask is not None:
        rows = torch.where(mask[..., None], rows, 0.0)
    if out is None:
        out = torch.zeros((num_rows, d), dtype=torch.float32, device=g.device)
    return out.index_add_(0, flat, rows.reshape(B * T * L, d))


def _declare_backward(lib: ctypes.CDLL):
    lib.drs_embedding_bag_backward.restype = ctypes.c_int
    lib.drs_embedding_bag_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,        # g, g dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
        ctypes.c_void_p,                                    # grad (f32)
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_void_p,                      # grid, stream
    ]


def embedding_bag_backward(g: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
                           num_rows: int, *, mask: torch.Tensor | None = None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient of ``embedding_bag`` with respect to its table (the
    gather's VJP, a scatter-add; JAX ``ops/embedding.py:770-800`` under
    ``jax.value_and_grad``).

    Args:
      g: ``(B, T, d)`` gradient of the pooled output, float32 or bfloat16.
      offsets, indices, mask: as ``embedding_bag`` took them.
      num_rows: the table's rows R.
      out: optional f32 ``(R, d)`` buffer to accumulate into; by default a
        zero-filled one is allocated.

    Returns:
      the f32 ``(R, d)`` gradient (``out``). Rows repeat within a batch,
      and the kernel adds them with atomics in no fixed order, so two runs
      agree to within the f32 rounding of the adds to each row.

    CPU tensors take ``embedding_bag_backward_reference``. CUDA tensors
    launch K1b and count the launch in
    ``embedding_bag_backward.kernel_launches``; a failed build or launch
    raises.
    """
    B, T, L = indices.shape
    d = g.shape[-1]
    if g.shape != (B, T, d) or d not in _KERNEL_WIDTHS or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"g must be (B, T, d) = ({B}, {T}, d) float32 or bfloat16 with "
                         f"d in {_KERNEL_WIDTHS}; got {tuple(g.shape)} {g.dtype}")
    if out is not None and (out.shape != (num_rows, d) or out.dtype != torch.float32
                            or not out.is_contiguous() or out.device != g.device):
        raise ValueError(f"out must be a contiguous float32 ({num_rows}, {d}) tensor on "
                         f"{g.device}; got {tuple(out.shape)} {out.dtype} on {out.device}")
    _check(g.new_empty((0, d)), offsets, indices, g.dtype, mask)
    if g.device.type == "cpu":
        return embedding_bag_backward_reference(g, offsets, indices, num_rows,
                                                mask=mask, out=out)
    if g.device.type != "cuda":
        raise ValueError(f"embedding_bag_backward runs on cpu or cuda, not {g.device}")
    g = g.contiguous()
    if out is None:
        out = torch.zeros((num_rows, d), dtype=torch.float32, device=g.device)
    if B * T == 0 or L == 0:
        return out
    tasks = B * T * -(-L // 32)  # a warp a bag and 32 of its slots
    grid = -(-tasks // K1B_WARPS_PER_BLOCK)
    _build.launch(_build.load("embedding_bag_backward", _declare_backward),
                  "drs_embedding_bag_backward", g.device,
                  g.data_ptr(), _DTYPE_CODES[g.dtype], d, offsets.data_ptr(),
                  indices.data_ptr(), mask.data_ptr() if mask is not None else None,
                  out.data_ptr(), B * T, T, L, grid)
    _build.count_launch(embedding_bag_backward)
    return out


embedding_bag_backward.kernel_launches = 0


def scatter_counts(offsets: torch.Tensor, indices: torch.Tensor, num_rows: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """``(num_rows,)`` f32: how many live slots add into each row."""
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    if mask is not None:
        ones = ones * mask.reshape(-1)
    return torch.zeros(num_rows, dtype=torch.float32, device=flat.device).index_add_(0, flat, ones)


def backward_tolerance(g: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
                       num_rows: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise bound on |a - b| for two f32 gradients of this op that
    differ only in the order of each row's adds: n_r * 2^-22 * sum|g| for a
    row of n_r adds (recursive summation error of both orders)."""
    abs_sum = embedding_bag_backward_reference(g.abs(), offsets, indices, num_rows, mask=mask)
    n = scatter_counts(offsets, indices, num_rows, mask)
    return n[:, None] * 2.0 ** -22 * abs_sum


class EmbeddingBagFunction(torch.autograd.Function):
    """``embedding_bag`` differentiable with respect to the table: forward
    K1 (or the plain version on the CPU), backward K1b (or its plain
    version). The gradient comes back in the table's dtype; for a bf16
    table it is summed in f32 and rounded once (JAX's bf16 scatter rounds
    at each add)."""

    @staticmethod
    def forward(ctx, table, offsets, indices, mask, cdt):
        ctx.save_for_backward(offsets, indices, mask)
        ctx.num_rows, ctx.table_dtype = table.shape[0], table.dtype
        return _dispatch(table, offsets, indices, mask, cdt)

    @staticmethod
    def backward(ctx, g):
        offsets, indices, mask = ctx.saved_tensors
        grad = embedding_bag_backward(g, offsets, indices, ctx.num_rows, mask=mask)
        return grad.to(ctx.table_dtype), None, None, None, None


# ------------------------------------------------- int8 tables (K1-int8, K4)

def _flat_ids(offsets: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return (indices.long() + offsets.long()[None, :, None]).reshape(-1)


def embedding_bag_int8_reference(q: torch.Tensor, scale: torch.Tensor | None,
                                 offsets: torch.Tensor, indices: torch.Tensor, *,
                                 compute_dtype: torch.dtype = torch.float32,
                                 mask: torch.Tensor | None = None,
                                 window: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch per-table int8 lookup: the bag's int8 rows summed in
    exact int32 (zero where masked out), converted to f32, multiplied by
    its table's f32 scale once and cast (JAX ``models/base.py:178-182``).
    With ``window`` (``window_ids``) ``q`` is a row shard and the result is
    its exact int32 pool; ``scale`` is not read."""
    B, T, L = indices.shape
    flat, mask = window_ids(offsets, indices, mask, window)
    rows = q.index_select(0, flat).to(torch.int32).reshape(B, T, L, -1)
    if mask is not None:
        rows = torch.where(mask[..., None], rows, 0)
    pooled = rows.sum(dim=2, dtype=torch.int32)
    if window is not None:
        return pooled
    return (pooled.float() * scale.float()[None, :, None]).to(compute_dtype)


def dequant_packed_rows(rows: torch.Tensor) -> torch.Tensor:
    """``(N, d + 4)`` int8 rows as ``(N, d)`` f32: each value times its
    row's scale, the f32 whose little-endian bytes are the row's last 4
    (JAX ``ops/embedding.py:251-259``)."""
    d = rows.shape[1] - 4
    scale = rows[:, d:].contiguous().view(torch.float32)
    return rows[:, :d].float() * scale


def _rowwise_values(qrows, offsets, indices, mask, window=None) -> torch.Tensor:
    """The dequantized rows of every slot, ``(B, T, L, d)`` f32, 0 where
    masked out (or, with ``window``, outside the shard)."""
    B, T, L = indices.shape
    flat, mask = window_ids(offsets, indices, mask, window)
    vals = dequant_packed_rows(qrows.index_select(0, flat))
    vals = vals.reshape(B, T, L, -1)
    return vals if mask is None else torch.where(mask[..., None], vals, 0.0)


def embedding_bag_int8_rowwise_reference(qrows: torch.Tensor, offsets: torch.Tensor,
                                         indices: torch.Tensor, *,
                                         compute_dtype: torch.dtype = torch.float32,
                                         mask: torch.Tensor | None = None,
                                         window: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch row-wise int8 lookup: ``dequant_packed_rows``, a sum
    over L in f32, one cast (JAX ``ops/embedding.py:262-284``). With
    ``window`` (``window_ids``) ``qrows`` is a row shard and the result is
    its f32 sum, not cast."""
    pooled = _rowwise_values(qrows, offsets, indices, mask, window).sum(dim=2)
    return pooled if window is not None else pooled.to(compute_dtype)


def rowwise_tolerance(a: torch.Tensor, b: torch.Tensor, qrows: torch.Tensor,
                      offsets: torch.Tensor, indices: torch.Tensor,
                      mask: torch.Tensor | None = None,
                      window: tuple[int, int] | None = None) -> torch.Tensor:
    """``pooled_tolerance`` on the dequantized rows: two row-wise pooled
    outputs whose products are the same f32 roundings and whose sums differ
    only in order (``window``: two f32 partials of a row shard)."""
    abs_sum = _rowwise_values(qrows, offsets, indices, mask, window).abs().sum(dim=2)
    return _order_tolerance(a, b, abs_sum, indices.shape[-1])


def _check_int8(table, row_bytes_extra: int, cdt, offsets, indices, mask, *others):
    """What K1-int8 (``row_bytes_extra`` 0) and K4 (4: the scale's bytes)
    take; both devices share the contract."""
    _check_int8_table(table, row_bytes_extra, cdt)
    _check_ids(table, offsets, indices, mask, *others)


def _check_int8_table(table, row_bytes_extra: int, cdt):
    if table.dtype != torch.int8:
        raise TypeError(f"an int8 table must be int8; got {table.dtype}")
    if table.dim() != 2 or table.shape[1] - row_bytes_extra not in _KERNEL_WIDTHS:
        widths = tuple(w + row_bytes_extra for w in _KERNEL_WIDTHS)
        raise ValueError(f"the int8 table must be (R, w) with w in {widths}; "
                         f"got {tuple(table.shape)}")
    if cdt not in _DTYPE_CODES:
        raise TypeError(f"the compute dtype must be float32 or bfloat16; got {cdt}")


def _declare_int8(lib: ctypes.CDLL):
    lib.drs_embedding_bag_int8.restype = ctypes.c_int
    lib.drs_embedding_bag_int8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # q, scale, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
        ctypes.c_void_p, ctypes.c_int,                      # out, out dtype
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: bags/warp, rows/lane, grid
        ctypes.c_void_p,                                    # stream
    ]
    lib.drs_embedding_bag_int8_rowwise.restype = ctypes.c_int
    lib.drs_embedding_bag_int8_rowwise.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                      # qrows, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
        ctypes.c_void_p, ctypes.c_int,                      # out, out dtype
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: bags/warp, rows/lane, grid
        ctypes.c_void_p,                                    # stream
    ]
    for fn in ("drs_embedding_bag_int8_window", "drs_embedding_bag_int8_rowwise_window"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_int,                      # shard, d
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # offsets, indices, mask
            ctypes.c_void_p,                                    # out (int32 or f32)
            ctypes.c_int64, ctypes.c_int64,                     # row_lo, rows of the shard
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: bags/warp, rows/lane, grid
            ctypes.c_void_p,                                    # stream
        ]


def _launch_int8(wrapper, fn: str, table, args, offsets, indices, mask, cdt, plan: K1Plan):
    """``wrapper``'s kernel in ``csrc/embedding_bag_int8.cu`` on checked
    CUDA inputs (``args``: its arguments before the offsets), counted."""
    B, T, L = indices.shape
    d = table.shape[1] - (4 if fn.endswith("rowwise") else 0)
    out = torch.empty((B, T, d), dtype=cdt, device=table.device)
    if B * T == 0:
        return out
    _build.launch(_build.load("embedding_bag_int8", _declare_int8), fn, table.device,
                  *args, offsets.data_ptr(), indices.data_ptr(),
                  mask.data_ptr() if mask is not None else None,
                  out.data_ptr(), _DTYPE_CODES[cdt], B * T, T, L,
                  plan.bags_per_warp, plan.rows_per_lane, plan.grid)
    _build.count_launch(wrapper)
    return out


def embedding_bag_int8(q: torch.Tensor, scale: torch.Tensor, offsets: torch.Tensor,
                       indices: torch.Tensor, *, compute_dtype: torch.dtype = torch.float32,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup over per-table int8 tables (JAX ``models/base.py:163-182``).

    Args:
      q: ``(R, d)`` int8 fused table, d 32 or 64.
      scale: ``(T,)`` f32 scale of each table.
      offsets, indices, mask: as ``embedding_bag`` takes them.

    Returns:
      ``(B, T, d)`` in ``compute_dtype``: the bag's int32 sum times its
      table's scale, the same bits as the JAX op's.

    CPU tensors take ``embedding_bag_int8_reference``. CUDA tensors launch
    K1-int8 with ``k1_launch_plan(..., torch.int8)``'s mapping (``q`` on a
    16-byte boundary) and count the launch in
    ``embedding_bag_int8.kernel_launches``; a failed build or launch raises.
    """
    cdt = compute_dtype
    _check_int8(q, 0, cdt, offsets, indices, mask, scale)
    if scale.shape != (indices.shape[1],) or scale.dtype != torch.float32:
        raise TypeError(f"scale must be ({indices.shape[1]},) float32; got "
                        f"{tuple(scale.shape)} {scale.dtype}")
    if q.device.type == "cpu":
        return embedding_bag_int8_reference(q, scale, offsets, indices,
                                            compute_dtype=cdt, mask=mask)
    if q.device.type != "cuda":
        raise ValueError(f"embedding_bag_int8 runs on cpu or cuda, not {q.device}")
    if q.data_ptr() % 16:
        raise ValueError("K1-int8 loads 16-byte vectors: the table must start on a "
                         "16-byte boundary")
    B, T, L = indices.shape
    return _launch_int8(embedding_bag_int8, "drs_embedding_bag_int8", q,
                        (q.data_ptr(), scale.data_ptr(), q.shape[1]), offsets, indices, mask,
                        cdt, k1_launch_plan(B * T, L, q.shape[1], torch.int8))


embedding_bag_int8.kernel_launches = 0


def embedding_bag_int8_rowwise(qrows: torch.Tensor, offsets: torch.Tensor,
                               indices: torch.Tensor, *,
                               compute_dtype: torch.dtype = torch.float32,
                               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup over row-wise int8 tables (JAX ``ops/embedding.py:262-284``).

    Args:
      qrows: ``(R, d + 4)`` int8 rows (``quantize_rowwise_int8``'s layout),
        d 32 or 64, starting on a 4-byte boundary (every row then does).
      offsets, indices, mask: as ``embedding_bag`` takes them.

    Returns:
      ``(B, T, d)`` in ``compute_dtype``: the f32 sum over L of each value
      times its row's scale, cast once. The kernel sums in another order
      than the plain version (``rowwise_tolerance``).

    CPU tensors take ``embedding_bag_int8_rowwise_reference``. CUDA tensors
    launch K4 with ``k4_launch_plan``'s mapping and count the launch in
    ``embedding_bag_int8_rowwise.kernel_launches``; a failed build or
    launch raises.
    """
    cdt = compute_dtype
    _check_int8(qrows, 4, cdt, offsets, indices, mask)
    if qrows.data_ptr() % 4:
        raise ValueError("row-wise rows hold an f32 scale: the table must start on a "
                         "4-byte boundary")
    if qrows.device.type == "cpu":
        return embedding_bag_int8_rowwise_reference(qrows, offsets, indices,
                                                    compute_dtype=cdt, mask=mask)
    if qrows.device.type != "cuda":
        raise ValueError(f"embedding_bag_int8_rowwise runs on cpu or cuda, not {qrows.device}")
    B, T, L = indices.shape
    d = qrows.shape[1] - 4
    return _launch_int8(embedding_bag_int8_rowwise, "drs_embedding_bag_int8_rowwise", qrows,
                        (qrows.data_ptr(), d), offsets, indices, mask, cdt,
                        k4_launch_plan(B * T, L, d))


embedding_bag_int8_rowwise.kernel_launches = 0


# ------------------------------------------- row shards (the ownership window)

def _check_window(table, row_lo: int):
    if row_lo < 0:
        raise ValueError(f"row_lo must be >= 0; got {row_lo}")
    return (row_lo, row_lo + table.shape[0])


def _launch_window(wrapper, fn: str, lib, table, args, offsets, indices, mask, out_dtype,
                   d: int, row_lo: int, plan: K1Plan, extra=()) -> torch.Tensor:
    """``fn`` (a window entry point of ``lib``) on checked CUDA inputs,
    counted in ``wrapper.kernel_launches``."""
    B, T, L = indices.shape
    out = torch.empty((B, T, d), dtype=out_dtype, device=table.device)
    if B * T == 0:
        return out
    _build.launch(lib, fn, table.device, *args, offsets.data_ptr(), indices.data_ptr(),
                  mask.data_ptr() if mask is not None else None, out.data_ptr(), *extra,
                  row_lo, table.shape[0], B * T, T, L, plan.bags_per_warp, plan.rows_per_lane,
                  plan.grid)
    _build.count_launch(wrapper)
    return out


def embedding_bag_shard(shard: torch.Tensor, offsets: torch.Tensor, indices: torch.Tensor,
                        row_lo: int, *, compute_dtype: torch.dtype | None = None,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """One row shard's part of ``embedding_bag`` (K1 with the ownership
    window; JAX ``parallel/sharding.py:102-130``).

    ``shard`` holds the fused table's rows ``[row_lo, row_lo + R_s)``; the
    ids are the whole batch's table-local ids. Returns the ``(B, T, d)`` f32
    partial: each row the shard owns converted to the compute dtype (default
    the shard's) and summed over L in f32, not rounded; a slot whose row
    another shard owns adds nothing. The shards' partials summed and cast
    once give ``embedding_bag`` up to the order of the f32 sums.

    CPU tensors take ``embedding_bag_reference(..., window=...)``; CUDA
    tensors launch K1's window instance with ``k1_launch_plan``'s mapping,
    counted in ``embedding_bag_shard.kernel_launches``.
    """
    cdt = compute_dtype if compute_dtype is not None else shard.dtype
    _check(shard, offsets, indices, cdt, mask)
    window = _check_window(shard, row_lo)
    if shard.device.type == "cpu":
        return embedding_bag_reference(shard, offsets, indices, compute_dtype=cdt, mask=mask,
                                       window=window)
    if shard.device.type != "cuda":
        raise ValueError(f"embedding_bag_shard runs on cpu or cuda, not {shard.device}")
    if shard.data_ptr() % 16:
        raise ValueError("the kernel loads 16-byte vectors: the shard must start on a "
                         "16-byte boundary")
    B, T, L = indices.shape
    d = shard.shape[1]
    return _launch_window(embedding_bag_shard, "drs_embedding_bag_window", _kernel_lib(), shard,
                          (shard.data_ptr(), _DTYPE_CODES[shard.dtype], d), offsets, indices,
                          mask, torch.float32, d, row_lo,
                          k1_launch_plan(B * T, L, d, shard.dtype), (_DTYPE_CODES[cdt],))


embedding_bag_shard.kernel_launches = 0


def embedding_bag_int8_shard(q_shard: torch.Tensor, offsets: torch.Tensor,
                             indices: torch.Tensor, row_lo: int, *,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """One row shard's part of ``embedding_bag_int8`` (K1-int8 with the
    ownership window): the ``(B, T, d)`` exact int32 pool of the rows the
    shard owns, before the scale. The shards' partials add exactly; their
    sum times the table's scale, cast once, is ``embedding_bag_int8`` bit
    for bit.

    CPU tensors take ``embedding_bag_int8_reference(..., window=...)``;
    CUDA tensors launch K1-int8's window instance, counted in
    ``embedding_bag_int8_shard.kernel_launches``."""
    _check_int8(q_shard, 0, torch.float32, offsets, indices, mask)
    window = _check_window(q_shard, row_lo)
    if q_shard.device.type == "cpu":
        return embedding_bag_int8_reference(q_shard, None, offsets, indices, mask=mask,
                                            window=window)
    if q_shard.device.type != "cuda":
        raise ValueError(f"embedding_bag_int8_shard runs on cpu or cuda, not {q_shard.device}")
    if q_shard.data_ptr() % 16:
        raise ValueError("K1-int8 loads 16-byte vectors: the shard must start on a "
                         "16-byte boundary")
    B, T, L = indices.shape
    d = q_shard.shape[1]
    return _launch_window(embedding_bag_int8_shard, "drs_embedding_bag_int8_window",
                          _build.load("embedding_bag_int8", _declare_int8), q_shard,
                          (q_shard.data_ptr(), d), offsets, indices, mask, torch.int32, d,
                          row_lo, k1_launch_plan(B * T, L, d, torch.int8))


embedding_bag_int8_shard.kernel_launches = 0


def embedding_bag_int8_rowwise_shard(qrows_shard: torch.Tensor, offsets: torch.Tensor,
                                     indices: torch.Tensor, row_lo: int, *,
                                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """One row shard's part of ``embedding_bag_int8_rowwise`` (K4 with the
    ownership window): the ``(B, T, d)`` f32 sum of the dequantized rows the
    shard owns, not cast.

    CPU tensors take ``embedding_bag_int8_rowwise_reference(...,
    window=...)``; CUDA tensors launch K4's window instance, counted in
    ``embedding_bag_int8_rowwise_shard.kernel_launches``."""
    _check_int8(qrows_shard, 4, torch.float32, offsets, indices, mask)
    window = _check_window(qrows_shard, row_lo)
    if qrows_shard.data_ptr() % 4:
        raise ValueError("row-wise rows hold an f32 scale: the shard must start on a "
                         "4-byte boundary")
    if qrows_shard.device.type == "cpu":
        return embedding_bag_int8_rowwise_reference(qrows_shard, offsets, indices, mask=mask,
                                                    window=window)
    if qrows_shard.device.type != "cuda":
        raise ValueError(f"embedding_bag_int8_rowwise_shard runs on cpu or cuda, not "
                         f"{qrows_shard.device}")
    B, T, L = indices.shape
    d = qrows_shard.shape[1] - 4
    return _launch_window(embedding_bag_int8_rowwise_shard,
                          "drs_embedding_bag_int8_rowwise_window",
                          _build.load("embedding_bag_int8", _declare_int8), qrows_shard,
                          (qrows_shard.data_ptr(), d), offsets, indices, mask, torch.float32,
                          d, row_lo, k4_launch_plan(B * T, L, d))


embedding_bag_int8_rowwise_shard.kernel_launches = 0


# ------------------------------------------------------- hot/cold (K6)

# K6's launch geometry, mirroring csrc/embedding_bag_hotcold.cu: G bags a
# warp (L > 8) or a slot a bag, K6_WARPS_PER_BLOCK warps a block.
K6_WARPS_PER_BLOCK = 8
_K6_MODES = {"float": 0, "int8": 1, "int8_rowwise": 2}
_SPLIT_KEYS = ("hot_sel", "hot_mask", "cold_ids", "cold_seg")


@dataclasses.dataclass(frozen=True)
class K6Geometry:
    """How K6 maps rows onto a warp (``Shipped`` in
    ``csrc/embedding_bag_hotcold.cu``): a lane holds ``values_per_lane``
    values of a row (16 bytes of a float or per-table int8 row; row-wise
    rows as the 16-byte-aligned chunks over them), ``lanes_per_row`` lanes
    cover a row, ``slots = 32 / lanes_per_row`` rows load at once. Where a
    warp pools long bags it pools ``bags_per_warp`` (G) of them, each on
    ``slots / G`` slots, ``rows_per_slot`` rows a slot a step, so a step
    reads ``chunk`` slots of a bag, and a window holds at most
    ``ids_per_lane`` ids a lane; where a slot pools a bag it loads at most
    ``rows_per_slot`` of the bag's rows a step. ``hint``: 0 none, 1 every
    row loads with K1's no-L1 hint, 2 only cold rows do."""

    values_per_lane: int
    lanes_per_row: int
    slots: int
    rows_per_slot: int
    hint: int
    bags_per_warp: int = 1
    ids_per_lane: int = 4

    @property
    def chunk(self) -> int:
        """Slots of a bag a step (long bags)."""
        return self.slots // self.bags_per_warp * self.rows_per_slot


@functools.lru_cache(maxsize=64)
def k6_geometry(mode: str, d: int, itemsize: int, short: bool = False) -> K6Geometry:
    """K6's geometry for a table layout (``mode`` of ``_K6_MODES``), width
    ``d``, element size (bytes) and bag length (``short``: L <= 8, a slot a
    bag). Float lanes load 16 bytes, d / 2 slots a step (at most 8 rows a
    slot); row-wise lanes hold 16 values, 16 slots a step; both load every
    row of a short bag at once. Cold rows of at most 64 bytes and row-wise
    rows load with the hint, float short bags every row (``k6_launch_plan``
    drops it for bags of one row, as K1 does). Per-table int8 lanes load 16
    bytes, cold rows with the hint; long bags take K1-int8's mappings
    (``k1_launch_plan(..., torch.int8)``: a warp a bag and 2 rows a slot a
    step at d = 32, 4 bags a warp and 4 rows at d = 64) with windows of one
    step (1 id a lane: the front end is pipelined across windows); short
    bags load every row at once. Chosen by measurement on an H100
    (``experiments/k6_sweep.py``, PERF.md)."""
    values = 16 if mode == "int8_rowwise" else 16 // itemsize
    lanes = d // values
    slots = 32 // lanes
    bags, ids = 1, 4
    if short:
        rows, hint = 8, 1 if mode == "float" else 2
    elif mode == "int8":
        rows, hint, ids = (2, 2, 1) if d == 32 else (4, 2, 1)
        bags = 1 if d == 32 else 4
    elif mode == "int8_rowwise":
        rows, hint = 16 // slots, 2
    else:
        rows, hint = min(d // 2 // slots, 8), 2 if d * itemsize <= 64 else 0
    return K6Geometry(values, lanes, slots, rows, hint, bags, ids)


@dataclasses.dataclass(frozen=True)
class K6Plan:
    """How K6 maps bags onto warps: ``rows_per_slot`` 0 is long bags,
    ``bags_per_warp`` (the geometry's G) a warp, whose slots' hot entries
    and cold ids load ``ids_per_lane`` a lane of the bag's lanes (a window
    of ``32 / G * ids_per_lane`` slots of the bag); else a slot a bag,
    ``bags_per_warp`` of them, each slot with its bag's rows (the power of
    two >= L) loaded ``geometry.rows_per_slot`` a step. ``grid`` blocks of
    K6_WARPS_PER_BLOCK warps cover every task once; ``geometry`` is the
    mapping launched."""

    bags_per_warp: int
    rows_per_slot: int
    ids_per_lane: int
    grid: int
    geometry: K6Geometry


def k6_window_ids(L: int, geo: K6Geometry) -> int:
    """ids_per_lane of a long-bag window: the power of two >= the bag's
    slots over its lanes, at most ``geo.ids_per_lane``, rounded up to whole
    steps (``csrc/embedding_bag_hotcold.cu::window_ids``)."""
    p = min(geo.ids_per_lane, _pow2_at_least(-(-L // (32 // geo.bags_per_warp))))
    m = geo.rows_per_slot // math.gcd(geo.rows_per_slot, geo.lanes_per_row)
    return -(-p // m) * m


@functools.lru_cache(maxsize=512)
def k6_launch_plan(n_bags: int, L: int, mode: str, d: int, itemsize: int) -> K6Plan:
    """K6's plan for ``n_bags`` bags of ``L`` slots of a layout; the only
    ones ``csrc/embedding_bag_hotcold.cu`` builds. Long bags load a window
    of ``k6_window_ids`` ids a lane (up to L = 128 in one window at G =
    1); short bags all of their rows, at most the geometry's a step."""
    short = L <= 8
    geo = k6_geometry(mode, d, itemsize, short)
    if short:
        u, bpw, ni = _pow2_at_least(max(L, 1)), geo.slots, 1
        geo = dataclasses.replace(geo, rows_per_slot=min(u, geo.rows_per_slot),
                                  hint=geo.hint if u > 1 else 0)  # one row: as K1
    else:
        u, bpw, ni = 0, geo.bags_per_warp, k6_window_ids(L, geo)
    tasks = -(-n_bags // bpw)
    return K6Plan(bpw, u, ni, max(1, -(-tasks // K6_WARPS_PER_BLOCK)), geo)


def hotcold_cold_starts_reference(cold_seg: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Plain PyTorch ``cold_start``, ``(n_bags + 1,)`` int32: the number of
    cold entries of bags before g, for g in [0, n_bags] (the CSR row pointer
    of the sorted cold stream; its last entry the first pad)."""
    counts = torch.bincount(cold_seg.long().clamp(max=n_bags), minlength=n_bags + 1)
    starts = torch.zeros(n_bags + 1, dtype=torch.int64, device=cold_seg.device)
    starts[1:] = torch.cumsum(counts[:n_bags], dim=0)
    return starts.to(torch.int32)


def hotcold_cold_starts(cold_seg: torch.Tensor, n_bags: int) -> torch.Tensor:
    """K6's first launch alone: ``cold_start`` of a sorted cold stream
    (``split_hot_cold``'s ``cold_seg``, pads ``n_bags`` last), for checks.
    CPU tensors take ``hotcold_cold_starts_reference``; on the card a failed
    launch raises. K6 itself builds these in the same launch sequence as it
    pools, so this call is not counted."""
    if cold_seg.dim() != 1 or cold_seg.dtype != torch.int32 or not cold_seg.is_contiguous():
        raise TypeError(f"cold_seg must be contiguous (C_pad,) int32; got "
                        f"{tuple(cold_seg.shape)} {cold_seg.dtype}")
    if cold_seg.device.type == "cpu":
        return hotcold_cold_starts_reference(cold_seg, n_bags)
    if cold_seg.device.type != "cuda":
        raise ValueError(f"hotcold_cold_starts runs on cpu or cuda, not {cold_seg.device}")
    _check_k6_sizes(cold_seg.numel(), n_bags)
    starts = torch.empty((n_bags + 1,), dtype=torch.int32, device=cold_seg.device)
    _build.launch(_build.load("embedding_bag_hotcold", _declare_hotcold),
                  "drs_hotcold_cold_starts", cold_seg.device, cold_seg.data_ptr() or None,
                  cold_seg.numel(), starts.data_ptr(), n_bags)
    return starts


def _check_k6_sizes(c_pad: int, n_bags: int):
    if c_pad >= 2 ** 31 - 1 or n_bags >= 2 ** 31 - 1:
        raise ValueError(f"K6 indexes the cold stream and the bags in int32; got C_pad "
                         f"{c_pad}, B*T {n_bags}")


def _hotcold_pooled(row_fn, acc_dtype: torch.dtype, hot: torch.Tensor, table: torch.Tensor,
                    split: dict) -> torch.Tensor:
    """The hot hits pooled over L plus the cold rows summed into their bags,
    ``(B, T, d)`` in ``acc_dtype``; ``row_fn`` maps gathered rows to the
    values that are summed."""
    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    B, T, L = hot_sel.shape
    cold = row_fn(table.index_select(0, split["cold_ids"].long()))
    d = cold.shape[1]
    if hot.shape[0]:
        rows = row_fn(hot.index_select(0, hot_sel.reshape(-1).long()))
        rows = torch.where(hot_mask.reshape(-1, 1), rows, torch.zeros((), dtype=rows.dtype))
        pooled = rows.reshape(B, T, L, d).sum(dim=2, dtype=acc_dtype)
    else:  # K = 0: no hot hits
        pooled = torch.zeros((B, T, d), dtype=acc_dtype, device=table.device)
    segs = torch.zeros((B * T + 1, d), dtype=acc_dtype, device=table.device)
    segs.index_add_(0, split["cold_seg"].long(), cold.to(acc_dtype))
    return pooled + segs[:B * T].reshape(B, T, d)  # the last bag holds the pads


def embedding_bag_hotcold_reference(hot_table: torch.Tensor, table: torch.Tensor, split: dict,
                                    *, compute_dtype: torch.dtype | None = None,
                                    partial: bool = False) -> torch.Tensor:
    """Plain PyTorch hot/cold lookup over float tables: each row converted
    to the compute dtype, hot hits and cold rows summed in f32, rounded once
    (``embedding_bag_reference``'s numerics, so it equals the direct lookup
    on the same ids up to the order of the f32 sum). ``partial``: the f32
    sum of a row shard, not rounded."""
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    pooled = _hotcold_pooled(lambda r: r.to(cdt).float(), torch.float32, hot_table, table, split)
    return pooled if partial else pooled.to(cdt)


def embedding_bag_hotcold_int8_reference(hot_q: torch.Tensor, q: torch.Tensor,
                                         scale: torch.Tensor | None, split: dict, *,
                                         compute_dtype: torch.dtype = torch.float32,
                                         partial: bool = False) -> torch.Tensor:
    """Plain PyTorch hot/cold lookup over per-table int8 tables: hot and
    cold rows summed in exact int32, one f32 multiply by the table's scale,
    one cast (JAX ``hotcold_quant_modes``). ``partial``: the int32 pool of
    a row shard, before the scale (``scale`` is not read)."""
    pooled = _hotcold_pooled(lambda r: r.to(torch.int32), torch.int32, hot_q, q, split)
    if partial:
        return pooled
    return (pooled.float() * scale.float()[None, :, None]).to(compute_dtype)


def embedding_bag_hotcold_int8_rowwise_reference(hot_qrows: torch.Tensor, qrows: torch.Tensor,
                                                 split: dict, *,
                                                 compute_dtype: torch.dtype = torch.float32,
                                                 partial: bool = False) -> torch.Tensor:
    """Plain PyTorch hot/cold lookup over row-wise int8 tables: every row
    dequantized by its own scale (``dequant_packed_rows``), an f32 sum, one
    cast. ``partial``: the f32 sum of a row shard, not cast."""
    pooled = _hotcold_pooled(dequant_packed_rows, torch.float32, hot_qrows, qrows, split)
    return pooled if partial else pooled.to(compute_dtype)


def hotcold_tolerance(a: torch.Tensor, b: torch.Tensor, hot: torch.Tensor, table: torch.Tensor,
                      split: dict, rowwise: bool = False) -> torch.Tensor:
    """``pooled_tolerance`` for two hot/cold outputs (float or row-wise
    tables) that differ only in the order of their f32 sums: a bag sums at
    most L rows, hot and cold together."""
    row_fn = (lambda r: dequant_packed_rows(r).abs()) if rowwise else (lambda r: r.float().abs())
    abs_sum = _hotcold_pooled(row_fn, torch.float32, hot, table, split)
    return _order_tolerance(a, b, abs_sum, split["hot_sel"].shape[-1])


def _check_hotcold(hot, table, split: dict, *others):
    """The split's arrays and the hot table as K6 takes them (both devices
    share the contract). The cold stream's order is not checked: it would
    cost a read back from the card."""
    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    cold_ids, cold_seg = split["cold_ids"], split["cold_seg"]
    if hot_sel.dim() != 3 or hot_sel.dtype != torch.int32:
        raise TypeError(f"hot_sel must be (B, T, L) int32; got {tuple(hot_sel.shape)} "
                        f"{hot_sel.dtype}")
    if hot_mask.shape != hot_sel.shape or hot_mask.dtype != torch.bool:
        raise TypeError(f"hot_mask must be bool of shape {tuple(hot_sel.shape)}; got "
                        f"{tuple(hot_mask.shape)} {hot_mask.dtype}")
    if (cold_ids.dim() != 1 or cold_ids.dtype != torch.int32
            or cold_seg.shape != cold_ids.shape or cold_seg.dtype != torch.int32):
        raise TypeError(f"cold_ids and cold_seg must be (C_pad,) int32; got "
                        f"{tuple(cold_ids.shape)} {cold_ids.dtype} and "
                        f"{tuple(cold_seg.shape)} {cold_seg.dtype}")
    if hot.dim() != 2 or hot.shape[1] != table.shape[1] or hot.dtype != table.dtype:
        raise ValueError(f"the hot table must be (K, {table.shape[1]}) {table.dtype}; got "
                         f"{tuple(hot.shape)} {hot.dtype}")
    tensors = (hot, table, hot_sel, hot_mask, cold_ids, cold_seg, *others)
    if any(t.device != table.device for t in tensors):
        raise ValueError("the tables and the split must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the tables and the split must be contiguous")


def _declare_hotcold(lib: ctypes.CDLL):
    lib.drs_embedding_bag_hotcold.restype = ctypes.c_int
    lib.drs_embedding_bag_hotcold.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # mode, table dtype, d
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # hot, table, scale
        ctypes.c_void_p, ctypes.c_void_p,                   # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # cold_ids, cold_seg, C_pad
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # cold_start, out, out dtype
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: rows/slot, ids/lane, grid
        ctypes.c_void_p,                                    # stream
    ]
    lib.drs_embedding_bag_hotcold_partial.restype = ctypes.c_int
    lib.drs_embedding_bag_hotcold_partial.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # mode, table dtype, d
        ctypes.c_void_p, ctypes.c_void_p,                   # hot, table (the shard)
        ctypes.c_void_p, ctypes.c_void_p,                   # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # cold_ids, cold_seg, C_pad
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # cold_start, out, compute dtype
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,         # B*T, T, L
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # plan: rows/slot, ids/lane, grid
        ctypes.c_void_p,                                    # stream
    ]
    lib.drs_hotcold_cold_starts.restype = ctypes.c_int
    lib.drs_hotcold_cold_starts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # cold_seg, C_pad, cold_start
        ctypes.c_int64, ctypes.c_void_p,                    # B*T, stream
    ]


def _hotcold_dispatch(wrapper, mode: str, hot, table, scale, split: dict, d: int, cdt,
                      align: int, plain, partial: bool = False):
    """``plain()`` for CPU tensors; on the card K6 (``mode``) on checked
    inputs: its two launches (``cold_start``, then the pool), counted once in
    ``wrapper.kernel_launches``. ``partial``: a row shard's sum, f32 (int32
    for per-table int8), before the scale and the rounding."""
    device = table.device
    if device.type == "cpu":
        return plain()
    if device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {device}")
    if table.data_ptr() % align or hot.data_ptr() % align:
        raise ValueError(f"K6 loads {align}-byte words: the table and the hot table must "
                         f"start on a {align}-byte boundary")
    hot_sel, cold_ids = split["hot_sel"], split["cold_ids"]
    B, T, L = hot_sel.shape
    out_dtype = (torch.int32 if mode == "int8" else torch.float32) if partial else cdt
    out = torch.empty((B, T, d), dtype=out_dtype, device=device)
    if B * T == 0:
        return out
    _check_k6_sizes(cold_ids.numel(), B * T)
    plan = k6_launch_plan(B * T, L, mode, d, table.element_size())
    starts = torch.empty((B * T + 1,), dtype=torch.int32, device=device)  # launch 1's output
    lib = _build.load("embedding_bag_hotcold", _declare_hotcold)
    head = (_K6_MODES[mode], _DTYPE_CODES.get(table.dtype, 0), d, hot.data_ptr() or None,
            table.data_ptr())
    stream = (hot_sel.data_ptr(), split["hot_mask"].data_ptr(), cold_ids.data_ptr() or None,
              split["cold_seg"].data_ptr() or None, cold_ids.numel(), starts.data_ptr(),
              out.data_ptr(), _DTYPE_CODES[cdt], B * T, T, L, plan.rows_per_slot,
              plan.ids_per_lane, plan.grid)
    if partial:
        _build.launch(lib, "drs_embedding_bag_hotcold_partial", device, *head, *stream)
    else:
        _build.launch(lib, "drs_embedding_bag_hotcold", device, *head,
                      None if scale is None else scale.data_ptr(), *stream)
    _build.count_launch(wrapper)
    return out


def embedding_bag_hotcold(hot_table: torch.Tensor, table: torch.Tensor, split: dict, *,
                          compute_dtype: torch.dtype | None = None,
                          pack: int = 1) -> torch.Tensor:
    """Pooled lookup over a hot/cold split (JAX ``ops/embedding.py:542``).

    Args:
      hot_table: ``(K, d)`` rows of the hot set (``table[hot_ids]``), K >= 0.
      table: fused ``(R, d)`` float32 or bfloat16 table, d 32 or 64.
      split: ``ops/hotcold.py::split_hot_cold``'s arrays as tensors on the
        table's device: ``hot_sel``/``hot_mask`` ``(B, T, L)``, the padded
        cold stream ``cold_ids``/``cold_seg`` ``(C_pad,)`` in its order (bags
        ascending, pads in bag ``B*T`` last). ``n_cold`` is not read.
      pack: the JAX package's packed cold tables; the port keeps ``(R, d)``
        rows, so only 1.

    Returns:
      ``(B, T, d)`` in ``compute_dtype`` (default: the table's): each row
      converted to it, the bag's hot and cold rows summed in f32, rounded
      once, as ``embedding_bag`` pools the same ids.

    CPU tensors take ``embedding_bag_hotcold_reference``. CUDA tensors
    launch K6 (``csrc/embedding_bag_hotcold.cu``: ``cold_start``, then the
    pool) and count the call once in
    ``embedding_bag_hotcold.kernel_launches``; a failed build or launch
    raises.
    """
    if pack != 1:
        raise NotImplementedError("packed cold tables: the port keeps (R, d) rows "
                                  "(bridge.params_from_numpy unpacks them)")
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    _check_float_table(table, cdt)
    _check_hotcold(hot_table, table, split)
    return _hotcold_dispatch(
        embedding_bag_hotcold, "float", hot_table, table, None, split, table.shape[1], cdt, 16,
        lambda: embedding_bag_hotcold_reference(hot_table, table, split, compute_dtype=cdt))


embedding_bag_hotcold.kernel_launches = 0


def embedding_bag_hotcold_int8(hot_q: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                               split: dict, *, compute_dtype: torch.dtype = torch.float32,
                               pack: int = 1) -> torch.Tensor:
    """Hot/cold lookup over per-table int8 tables (JAX
    ``ops/embedding.py:737``): hot and cold rows summed in exact int32, one
    f32 multiply by the table's scale, one cast: the JAX op's bits.

    ``hot_q`` ``(K, d)`` int8 (``q[hot_ids]``), ``q`` ``(R, d)`` int8,
    ``scale`` ``(T,)`` f32, ``split`` as ``embedding_bag_hotcold`` takes it.
    CPU tensors take the plain version; CUDA tensors launch K6 (per-table
    mode), counted in ``embedding_bag_hotcold_int8.kernel_launches``.
    """
    if pack != 1:
        raise NotImplementedError("packed cold tables: the port keeps (R, d) rows "
                                  "(bridge.params_from_numpy unpacks them)")
    cdt = compute_dtype
    _check_int8_table(q, 0, cdt)
    if scale.shape != (split["hot_sel"].shape[1],) or scale.dtype != torch.float32:
        raise TypeError(f"scale must be ({split['hot_sel'].shape[1]},) float32; got "
                        f"{tuple(scale.shape)} {scale.dtype}")
    _check_hotcold(hot_q, q, split, scale)
    return _hotcold_dispatch(
        embedding_bag_hotcold_int8, "int8", hot_q, q, scale, split, q.shape[1], cdt, 16,
        lambda: embedding_bag_hotcold_int8_reference(hot_q, q, scale, split, compute_dtype=cdt))


embedding_bag_hotcold_int8.kernel_launches = 0


def embedding_bag_hotcold_int8_rowwise(hot_qrows: torch.Tensor, qrows: torch.Tensor,
                                       split: dict, *,
                                       compute_dtype: torch.dtype = torch.float32
                                       ) -> torch.Tensor:
    """Hot/cold lookup over row-wise int8 tables (JAX
    ``ops/embedding.py:759``): every row, hot or cold, dequantized by its
    own scale before an f32 sum, one cast.

    ``hot_qrows`` ``(K, d + 4)`` int8 (``qrows[hot_ids]``), ``qrows``
    ``(R, d + 4)`` int8 on 4-byte boundaries, ``split`` as
    ``embedding_bag_hotcold`` takes it. CPU tensors take the plain version;
    CUDA tensors launch K6 (row-wise mode), counted in
    ``embedding_bag_hotcold_int8_rowwise.kernel_launches``.
    """
    cdt = compute_dtype
    _check_int8_table(qrows, 4, cdt)
    _check_hotcold(hot_qrows, qrows, split)
    return _hotcold_dispatch(
        embedding_bag_hotcold_int8_rowwise, "int8_rowwise", hot_qrows, qrows, None, split,
        qrows.shape[1] - 4, cdt, 4,
        lambda: embedding_bag_hotcold_int8_rowwise_reference(hot_qrows, qrows, split,
                                                             compute_dtype=cdt))


embedding_bag_hotcold_int8_rowwise.kernel_launches = 0


def embedding_bag_hotcold_shard(hot_table: torch.Tensor, shard: torch.Tensor, split: dict, *,
                                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One row shard's part of ``embedding_bag_hotcold`` (K6 on a shard):
    ``split``'s ``cold_ids`` are the shard's own cold ids, already local to
    it (``ops/hotcold.py::split_hot_cold_sharded``, ``_hybrid``), and its
    ``hot_mask`` marks the hits this shard counts (all false on every shard
    but one, so the hot part is counted once). Returns the ``(B, T, d)`` f32
    partial, each row converted to the compute dtype and summed, not
    rounded. CPU tensors take ``embedding_bag_hotcold_reference(...,
    partial=True)``; CUDA tensors launch K6, counted in
    ``embedding_bag_hotcold_shard.kernel_launches``."""
    cdt = compute_dtype if compute_dtype is not None else shard.dtype
    _check_float_table(shard, cdt)
    _check_hotcold(hot_table, shard, split)
    return _hotcold_dispatch(
        embedding_bag_hotcold_shard, "float", hot_table, shard, None, split, shard.shape[1], cdt,
        16, lambda: embedding_bag_hotcold_reference(hot_table, shard, split, compute_dtype=cdt,
                                                    partial=True), partial=True)


embedding_bag_hotcold_shard.kernel_launches = 0


def embedding_bag_hotcold_int8_shard(hot_q: torch.Tensor, q_shard: torch.Tensor,
                                     split: dict) -> torch.Tensor:
    """``embedding_bag_hotcold_shard`` over a per-table int8 shard: the
    ``(B, T, d)`` exact int32 pool before the scale (K6-int8 with an int32
    output). CPU tensors take the plain version; CUDA tensors launch K6,
    counted in ``embedding_bag_hotcold_int8_shard.kernel_launches``."""
    _check_int8_table(q_shard, 0, torch.float32)
    _check_hotcold(hot_q, q_shard, split)
    return _hotcold_dispatch(
        embedding_bag_hotcold_int8_shard, "int8", hot_q, q_shard, None, split, q_shard.shape[1],
        torch.float32, 16,
        lambda: embedding_bag_hotcold_int8_reference(hot_q, q_shard, None, split, partial=True),
        partial=True)


embedding_bag_hotcold_int8_shard.kernel_launches = 0


def embedding_bag_hotcold_int8_rowwise_shard(hot_qrows: torch.Tensor, qrows_shard: torch.Tensor,
                                             split: dict) -> torch.Tensor:
    """``embedding_bag_hotcold_shard`` over a row-wise int8 shard: the
    ``(B, T, d)`` f32 sum of the dequantized rows, not cast. CPU tensors
    take the plain version; CUDA tensors launch K6, counted in
    ``embedding_bag_hotcold_int8_rowwise_shard.kernel_launches``."""
    _check_int8_table(qrows_shard, 4, torch.float32)
    _check_hotcold(hot_qrows, qrows_shard, split)
    return _hotcold_dispatch(
        embedding_bag_hotcold_int8_rowwise_shard, "int8_rowwise", hot_qrows, qrows_shard, None,
        split, qrows_shard.shape[1] - 4, torch.float32, 4,
        lambda: embedding_bag_hotcold_int8_rowwise_reference(hot_qrows, qrows_shard, split,
                                                             partial=True), partial=True)


embedding_bag_hotcold_int8_rowwise_shard.kernel_launches = 0


# ---------------------------------------------------------- export helpers

def quantize_rowwise_int8(table: torch.Tensor) -> torch.Tensor:
    """A float ``(R, d)`` table as ``(R, d + 4)`` int8 rows: symmetric int8
    values at a per-row scale max|row| / 127, the last 4 bytes the scale's
    float32 bit pattern (JAX ``ops/embedding.py:211-235``; the arithmetic
    in the table's dtype, as there)."""
    scale = torch.clamp(table.abs().amax(dim=1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(table / scale[:, None]), -127, 127).to(torch.int8)
    scale_bytes = scale.float().contiguous().view(torch.int8).reshape(-1, 4)
    return torch.cat([q, scale_bytes], dim=1)


def quantize_pertable_int8(table: torch.Tensor, table_rows) -> dict:
    """A float fused table as per-table int8: ``{"q": (R, d) int8, "scale":
    (T,) f32}`` with scale_t = max|table t| / 127, arithmetic in f32 (JAX
    ``ops/embedding.py:557-583``). The division by 127 is a multiplication
    by f32(1/127), as in the JAX package's jitted program (XLA rewrites a
    division by a constant so), which keeps the exported bytes equal."""
    counts = torch.as_tensor(np.asarray(table_rows, dtype=np.int64), device=table.device)
    tid = torch.repeat_interleave(torch.arange(len(counts), device=table.device), counts)
    t32 = table.float()
    absmax = torch.zeros(len(counts), dtype=torch.float32, device=table.device)
    absmax.scatter_reduce_(0, tid, t32.abs().amax(dim=1), "amax", include_self=False)
    scale = torch.clamp(absmax, min=1e-30) * np.float32(1.0 / 127.0).item()
    q = torch.clamp(torch.round(t32 / scale[tid][:, None]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}
