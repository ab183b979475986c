"""Host side of hot/cold-split lookups: the split and the hot-set choice.

Counterpart of ``deeprecsys_tpu/ops/embedding.py`` (``_pad_bucket`` :287,
``_split_hot_cold_native`` and ``split_hot_cold`` :347-480,
``hot_coverage_of`` :585, ``scan_budget_subsample`` :607,
``select_hot_ids`` :627). All numpy; ``tests/test_torch_hotcold.py`` holds
each equal to its original on the same inputs.

A batch's ``(B, T, L)`` lookups split into hits of a sorted hot set of
fused row ids (``hot_sel``, the position in the hot set, and ``hot_mask``)
and a compacted cold stream (``cold_ids``, fused ids, and ``cold_seg``, the
bag ``b*T + t`` of each). The cold stream keeps the order of the lookups,
so each bag's cold slots are contiguous and the bags ascend; it is padded to
a bucket with id 0 in bag ``B*T``, which is past every real bag, so the pads
come last. The card's kernel K6 (``ops/embedding.py::embedding_bag_hotcold``)
relies on that order.

The native path is the C++ splitter of ``runtime/cpp/drs_runtime.cpp``: one
parallel pass (its chunks aligned to L and moved tight in order, so the
order is the numpy path's), called through ctypes with the GIL released.
``impl="auto"`` takes it when the library builds, else the numpy path.
"""

from __future__ import annotations

import threading

import numpy as np

_NATIVE_LOCK = threading.Lock()


def _pad_bucket(n: int, buckets, floor: int = 1) -> int:
    """Smallest configured bucket that fits ``n`` (exact ``n`` if none
    does); without buckets, the next power of two >= max(n, floor)."""
    if buckets is None:
        return max(floor, 1 << max(0, (n - 1)).bit_length())
    fitting = [b for b in sorted(buckets) if b >= n]
    return fitting[0] if fitting else n


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _split_hot_cold_native(indices: np.ndarray, offsets: np.ndarray, hot_ids: np.ndarray,
                           slot_mask: "np.ndarray | None" = None, hot_index=None,
                           out: "dict | None" = None):
    """The C++ single-pass splitter (``drs_split_hot_cold_indexed``).
    Returns ``(hot_sel, hot_mask, cold_ids, cold_seg, n_cold)`` as the numpy
    path computes them, unpadded: the cold arrays have ``B*T*L`` entries of
    which the first ``n_cold`` are the stream. ``slot_mask``: invalid slots
    are neither hot hits nor cold lookups. ``hot_index``: a
    ``runtime.native.HotIndex`` over the same ``hot_ids``. ``out``: flat
    buffers to write into (``split_hot_cold``'s). Each call adds one to
    ``_split_hot_cold_native.calls``."""
    from deeprecsys_tpu_torch.runtime.native import get_lib

    lib = get_lib()
    B, T, L = indices.shape
    n = B * T * L
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    hot = np.ascontiguousarray(hot_ids, dtype=np.int64)
    if out is None:
        hot_sel, hot_mask = np.empty(n, np.int32), np.empty(n, np.bool_)
        cold_ids, cold_seg = np.empty(n, np.int32), np.empty(n, np.int32)
    else:
        hot_sel, hot_mask = out["hot_sel"][:n], out["hot_mask"][:n]
        cold_ids, cold_seg = out["cold_ids"][:n], out["cold_seg"][:n]
    smask = None if slot_mask is None else np.ascontiguousarray(slot_mask, dtype=np.bool_)
    index_ptr = None
    if hot_index is not None and hot_index._ptr:
        if hot_index.K != len(hot):
            raise ValueError(f"hot_index built over {hot_index.K} ids but split called with "
                             f"{len(hot)}: stale index (rebuild on hot-set swap)")
        index_ptr = hot_index._ptr
    n_cold = lib.drs_split_hot_cold_indexed(
        _ptr(idx), n, _ptr(offs), T, L, _ptr(hot), len(hot),
        None if smask is None else _ptr(smask), index_ptr,
        _ptr(hot_sel), _ptr(hot_mask), _ptr(cold_ids), _ptr(cold_seg), 0)
    with _NATIVE_LOCK:
        _split_hot_cold_native.calls += 1
    return hot_sel, hot_mask, cold_ids, cold_seg, int(n_cold)


_split_hot_cold_native.calls = 0


def split_hot_cold(indices: np.ndarray, offsets: np.ndarray, hot_ids: np.ndarray,
                   cold_buckets=None, impl: str = "auto", pad: bool = True,
                   slot_mask: "np.ndarray | None" = None, hot_index=None,
                   out: "dict | None" = None) -> dict:
    """Split a batch's lookups into hot-set hits and a compacted cold
    stream (JAX ``ops/embedding.py:407-480``).

    Args:
      indices: ``(B, T, L)`` table-local ids.
      offsets: ``(T,)`` fused row offsets.
      hot_ids: SORTED fused row ids of the hot set (K of them).
      cold_buckets: ascending pad buckets for the cold count.
      impl: "auto" (native if the library builds, else numpy), "native" or
        "numpy".
      pad: False returns the cold stream at its exact length.
      slot_mask: ``(B, T, L)`` bool, ragged pooling: an invalid slot is
        neither a hot hit nor a cold lookup.
      hot_index: ``runtime.native.HotIndex`` over the same ``hot_ids`` (the
        native path's hash probe; the same outputs without it).
      out: optional flat numpy buffers ``{"hot_sel": int32, "hot_mask":
        bool, "cold_ids": int32, "cold_seg": int32}`` of at least
        ``max(B*T*L, C_pad)`` entries each (a serving engine's pinned
        staging slot); the results are written there and returned as views.

    Returns ``{"hot_sel": (B, T, L) int32, "hot_mask": (B, T, L) bool,
    "cold_ids": (C_pad,) int32, "cold_seg": (C_pad,) int32, "n_cold": int}``
    with pads of id 0 in bag ``B*T``.
    """
    B, T, L = indices.shape
    n = B * T * L
    use_native = impl == "native"
    if impl == "auto":
        from deeprecsys_tpu_torch.runtime.native import native_available

        use_native = native_available()

    if use_native:
        hot_sel, hot_mask, raw_cold_ids, raw_cold_seg, n_cold = _split_hot_cold_native(
            indices, offsets, hot_ids, slot_mask=slot_mask, hot_index=hot_index, out=out)
    else:
        flat = (indices.astype(np.int64)
                + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
        pos = np.searchsorted(hot_ids, flat)
        pos_c = np.clip(pos, 0, len(hot_ids) - 1)
        hot_mask = hot_ids[pos_c] == flat if len(hot_ids) else np.zeros(flat.shape, bool)
        if slot_mask is not None:
            valid = np.asarray(slot_mask, dtype=bool).reshape(-1)
            hot_mask &= valid
            not_cold = hot_mask | ~valid  # invalid slots are not cold either
        else:
            not_cold = hot_mask
        hot_sel = np.where(hot_mask, pos_c, 0).astype(np.int32)
        cold_positions = np.flatnonzero(~not_cold)
        n_cold = int(cold_positions.size)
        groups = (np.arange(n) // L).astype(np.int32)
        raw_cold_ids = flat[cold_positions]
        raw_cold_seg = groups[cold_positions]
        if out is not None:
            out["hot_sel"][:n], out["hot_mask"][:n] = hot_sel, hot_mask
            out["cold_ids"][:n_cold], out["cold_seg"][:n_cold] = raw_cold_ids, raw_cold_seg
            hot_sel, hot_mask = out["hot_sel"][:n], out["hot_mask"][:n]
            raw_cold_ids, raw_cold_seg = out["cold_ids"], out["cold_seg"]

    shaped = {"hot_sel": hot_sel.reshape(B, T, L), "hot_mask": hot_mask.reshape(B, T, L)}
    if not pad:
        return {**shaped, "cold_ids": np.asarray(raw_cold_ids[:n_cold], dtype=np.int32),
                "cold_seg": np.asarray(raw_cold_seg[:n_cold], dtype=np.int32),
                "n_cold": n_cold}
    c_pad = _pad_bucket(n_cold, cold_buckets)
    if out is None:
        cold_ids = np.zeros(c_pad, dtype=np.int32)
        cold_seg = np.full(c_pad, B * T, dtype=np.int32)  # pads -> the dropped bag
        cold_ids[:n_cold] = raw_cold_ids[:n_cold]
        cold_seg[:n_cold] = raw_cold_seg[:n_cold]
    else:
        cold_ids, cold_seg = out["cold_ids"][:c_pad], out["cold_seg"][:c_pad]
        cold_ids[n_cold:] = 0
        cold_seg[n_cold:] = B * T
    return {**shaped, "cold_ids": cold_ids, "cold_seg": cold_seg, "n_cold": n_cold}


def hot_coverage_of(indices: np.ndarray, offsets: np.ndarray, hot_ids: np.ndarray,
                    mask: "np.ndarray | None" = None) -> float:
    """Share of a ``(B, T, L)`` lookup stream that a SORTED fused hot-id set
    serves; with ``mask`` only valid slots count (JAX :585)."""
    if len(hot_ids) == 0:
        return 0.0
    hot_ids = np.asarray(hot_ids)
    flat = (np.asarray(indices).astype(np.int64)
            + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
    if mask is not None:
        flat = flat[np.asarray(mask, dtype=bool).reshape(-1)]
        if flat.size == 0:
            return 0.0
    pos = np.clip(np.searchsorted(hot_ids, flat), 0, len(hot_ids) - 1)
    return float((hot_ids[pos] == flat).mean())


def scan_budget_subsample(arr: np.ndarray, budget: int) -> np.ndarray:
    """A row-stride subsample of a ``(B, T, L)`` window that holds at most
    ``budget`` lookups (at least 2 rows; ``budget <= 0``: all of it), so
    the hot-set scan's sort stays bounded (JAX :607)."""
    if budget <= 0:
        return arr
    per_row = arr.shape[1] * arr.shape[2]
    max_rows = max(budget // per_row, 2)
    if arr.shape[0] <= max_rows:
        return arr
    stride = -(-arr.shape[0] // max_rows)
    return arr[::stride]


def select_hot_ids(indices_sample: np.ndarray, offsets: np.ndarray, k: int,
                   mask: "np.ndarray | None" = None) -> np.ndarray:
    """The ``k`` most frequent fused row ids of a ``(B, T, L)`` sample,
    SORTED; with ``mask`` padded slots are left out (JAX :627)."""
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    flat = (indices_sample.astype(np.int64)
            + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
    if mask is not None:
        flat = flat[np.asarray(mask, dtype=bool).reshape(-1)]
    uniq, counts = np.unique(flat, return_counts=True)
    if len(uniq) <= k:
        return np.sort(uniq)
    top = np.argpartition(counts, -k)[-k:]
    return np.sort(uniq[top])
