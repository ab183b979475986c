"""Ragged (lengths + values) sparse input.

Counterpart of ``deeprecsys_tpu/data/ragged.py``. The reference feeds
SparseLengthsSum per-table (lengths, indices) queues
(``dlrm_s_caffe2.py:179-211``), a CSR form with variable pooling lengths.
This turns it into the port's layout: ``(B, T, L)`` ids padded with 0 and a
``(B, T, L)`` bool mask, which ``models.base.pooled_lookup`` hands to every
lookup kernel (a masked slot adds nothing to its bag, so any group length,
empty included, pools exactly).
"""

from __future__ import annotations

import numpy as np


def _exact_int64(arr, what: str) -> np.ndarray:
    """``arr`` as int64, refusing non-integral floats: JSON writers may send
    ids as 1.0, but truncating 1.9 to 1 would score the wrong rows."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        as_int = arr.astype(np.int64)
        if not np.array_equal(as_int, arr):
            raise ValueError(f"{what} must be integral; got non-integer float values "
                             f"(refusing to truncate)")
        return as_int
    return arr.astype(np.int64)


def lengths_to_mask(lengths, max_len: int) -> np.ndarray:
    """(B, T) group lengths -> (B, T, L) bool slot mask."""
    lengths = _exact_int64(lengths, "lengths")
    if lengths.ndim != 2:
        raise ValueError(f"lengths must be (B, T); got shape {lengths.shape}")
    if (lengths < 0).any() or (lengths > max_len).any():
        raise ValueError(f"each group length must satisfy 0 <= len <= {max_len} "
                         f"(the model's num_indices_per_lookup)")
    return np.arange(max_len)[None, None, :] < lengths[:, :, None]


def pad_csr(lengths, values, max_len: int):
    """CSR -> (ids (B, T, L) int64 padded with 0, mask (B, T, L) bool).

    ``lengths``: (B, T) counts a group; ``values``: every group's ids,
    concatenated in row-major (b, t) order (the reference's lengths and
    indices queues of one batch, fused across tables)."""
    lengths = _exact_int64(lengths, "lengths")
    values = _exact_int64(values, "values").reshape(-1)
    mask = lengths_to_mask(lengths, max_len)
    if int(lengths.sum()) != values.size:
        raise ValueError(f"values has {values.size} ids but lengths sum to "
                         f"{int(lengths.sum())}")
    idx = np.zeros(mask.shape, dtype=np.int64)
    idx[mask] = values
    return idx, mask
