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
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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


def unpack_table(table_packed: torch.Tensor, pack: int, total_rows: int) -> torch.Tensor:
    """Logical ``(total_rows, d)`` view of a ``(ceil(R/pack), pack*d)``
    packed table (inverse of the JAX package's ``pack_table``)."""
    if pack <= 1:
        return table_packed
    d = table_packed.shape[1] // pack
    return table_packed.reshape(-1, d)[:total_rows]


def embedding_bag_reference(table: torch.Tensor, offsets: torch.Tensor,
                            indices: torch.Tensor, *,
                            compute_dtype: torch.dtype | None = None,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch pooled lookup: each gathered row converted to the
    compute dtype, summed over L in f32 and rounded once (the JAX op's
    numerics: a bf16 ``jnp.sum`` accumulates in f32). Masked-out slots
    contribute zero."""
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    B, T, L = indices.shape
    flat = (indices.long() + offsets.long()[None, :, None]).reshape(-1)
    rows = table.index_select(0, flat).to(cdt).float().reshape(B, T, L, -1)
    if mask is not None:
        rows = torch.where(mask[..., None], rows, 0.0)
    return rows.sum(dim=2).to(cdt)


def pooled_tolerance(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                     offsets: torch.Tensor, indices: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise bound on |a - b| for two pooled outputs of this op that
    differ only in the order of their f32 sums: L * 2^-23 * sum|rows|
    (recursive summation error, both orders together), plus one bf16 ulp of
    the larger value when the outputs are bf16 (each side rounds once)."""
    abs_sum = embedding_bag_reference(table.abs(), offsets, indices,
                                      compute_dtype=torch.float32, mask=mask)
    tol = indices.shape[-1] * 2.0 ** -23 * abs_sum
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
    """
    S = 32 // (d * table_dtype.itemsize // 16)
    G, U = (S, _pow2_at_least(max(L, 1))) if L <= 8 else (1, 4)
    tasks = -(-n_bags // G)
    grid = max(1, -(-tasks // K1_WARPS_PER_BLOCK))
    return K1Plan(bags_per_warp=G, rows_per_lane=U, row_slots=S, tasks=tasks, grid=grid)


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


def _kernel_lib() -> ctypes.CDLL:
    return _build.load("embedding_bag", _declare)


def _check(table, offsets, indices, cdt, mask):
    """Raise on anything the kernel does not take (both devices share the
    contract, so the CPU tests exercise these checks too)."""
    if table.dim() != 2 or table.shape[1] not in _KERNEL_WIDTHS:
        raise ValueError(f"table must be (R, d) with d in {_KERNEL_WIDTHS}; "
                         f"got {tuple(table.shape)}")
    if table.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES:
        raise TypeError(f"table and compute dtypes must be float32 or bfloat16; "
                        f"got {table.dtype} and {cdt}")
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
            mask is not None and mask.device != device):
        raise ValueError("table, offsets, indices and mask must be on one device")
    if not (table.is_contiguous() and offsets.is_contiguous() and indices.is_contiguous()
            and (mask is None or mask.is_contiguous())):
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
        The kernel does not check the range (the JAX gather fills an
        out-of-range row with NaN; see ROADMAP.md Queue 3).
      mask: optional ``(B, T, L)`` bool; masked-out slots contribute zero.

    Returns:
      ``(B, T, d)`` pooled rows in ``compute_dtype`` (default: the table's).

    CPU tensors take ``embedding_bag_reference``. CUDA tensors launch K1
    with ``k1_launch_plan``'s mapping and count the launch in
    ``embedding_bag.kernel_launches``; a failed build or launch raises.
    """
    cdt = compute_dtype if compute_dtype is not None else table.dtype
    _check(table, offsets, indices, cdt, mask)
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
