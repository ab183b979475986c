"""Shared-memory blob arena: the payloads of cpu-mp engine processes.

Counterpart of ``deeprecsys_tpu/runtime/blob_arena.py``, the same slot
layout byte for byte. The ring's 64-byte packets cannot carry a request's
feature arrays, so a ``SharedMemory`` segment of fixed slots carries them
and the packet carries the slot id (``ServiceRequest.payload_slot``).

Ownership, one allocator and no lock across processes:

- the parent allocates a slot (its free list, under a lock), writes the
  sub-request's features and pushes the request packet; the ring's push
  and pop are release and acquire, so the child sees the bytes before the
  packet;
- the child copies the features out, runs them, writes the scores into the
  same slot and then pushes its response;
- the parent reads the scores when the response arrives and frees the
  slot. An error response frees it unread. A slot whose engine died in
  flight stays taken until the arena is unlinked at server stop.

A slot holds a header (kind, n_rows, T, L, dense_dim, out_dim or the mask
flag; int32 each), then int32 ids, f32 dense features and a bool mask, or
the f32 scores. It is sized for the largest sub-request the serving config
makes.
"""

from __future__ import annotations

import threading

import numpy as np

_HDR_WORDS = 6
_HDR_BYTES = _HDR_WORDS * 4
_K_BATCH, _K_SCORES = 1, 2


def slot_bytes_for(n_rows: int, num_tables: int, lookups: int, dense_dim: int,
                   out_dim: int, with_mask: bool = False) -> int:
    """Bytes of a slot that holds a batch of ``n_rows`` (with its ragged
    mask, 1 byte a lookup, when ``with_mask``) or its scores, rounded up to
    64."""
    payload = n_rows * (num_tables * lookups * 4 + dense_dim * 4)
    if with_mask:
        payload += n_rows * num_tables * lookups
    n = _HDR_BYTES + max(payload, n_rows * out_dim * 4)
    return -(-n // 64) * 64


class BlobArena:
    """Fixed slots over ``multiprocessing.shared_memory``. ``create=True``
    (the parent) allocates, frees and unlinks; a child attaches by name and
    only reads and writes the slots its packets name."""

    def __init__(self, name: str, n_slots: int, slot_bytes: int, create: bool = True):
        from multiprocessing import shared_memory

        self.n_slots = int(n_slots)
        self.slot_bytes = int(slot_bytes)
        self.name = name
        self._created = create
        self._shm = shared_memory.SharedMemory(
            name=name, create=create, size=self.n_slots * self.slot_bytes if create else 0)
        self._free = list(range(self.n_slots)) if create else None
        self._free_set = set(self._free) if create else None
        self._lock = threading.Lock() if create else None

    # -- the parent's allocation -------------------------------------------

    def alloc(self) -> int:
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    f"payload arena exhausted ({self.n_slots} slots in flight); raise the "
                    f"slot count or apply client-side backpressure")
            slot = self._free.pop()
            self._free_set.discard(slot)
            return slot

    def free(self, slot: int):
        # A slot freed twice would be handed to two queries at once, whose
        # bytes would then alias: refuse it.
        with self._lock:
            if not 0 <= slot < self.n_slots:
                raise ValueError(f"free of slot {slot} outside [0, {self.n_slots})")
            if slot in self._free_set:
                raise RuntimeError(f"double free of arena slot {slot}")
            self._free.append(slot)
            self._free_set.add(slot)

    def in_flight(self) -> int:
        with self._lock:
            return self.n_slots - len(self._free)

    # -- slot IO -------------------------------------------------------------

    def _view(self, slot: int) -> memoryview:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        off = slot * self.slot_bytes
        return self._shm.buf[off: off + self.slot_bytes]

    def _write(self, slot: int, header: list, body: bytes, what: str):
        if _HDR_BYTES + len(body) > self.slot_bytes:
            raise ValueError(f"{what} ({_HDR_BYTES + len(body)} B) exceeds the arena slot "
                             f"size ({self.slot_bytes} B)")
        view = self._view(slot)
        view[:_HDR_BYTES] = np.asarray(header, dtype=np.int32).tobytes()
        view[_HDR_BYTES:_HDR_BYTES + len(body)] = body

    def write_batch(self, slot: int, indices: np.ndarray, dense: np.ndarray | None,
                    mask: np.ndarray | None = None):
        """Parent: one sub-request's (n, T, L) ids, (n, dense_dim) dense
        features and optional (n, T, L) ragged mask into ``slot``."""
        n, T, L = indices.shape
        body = indices.astype(np.int32, copy=False).tobytes()
        if dense is not None:
            body += dense.astype(np.float32, copy=False).tobytes()
        if mask is not None:
            body += mask.astype(np.bool_, copy=False).tobytes()
        dd = 0 if dense is None else int(dense.shape[1])
        self._write(slot, [_K_BATCH, n, T, L, dd, 0 if mask is None else 1], body, "payload")

    def read_batch(self, slot: int):
        """Child: (ids (n, T, L) int32, dense (n, dd) f32 or None, mask
        (n, T, L) bool or None), copied out (the slot then takes the
        scores)."""
        view = self._view(slot)
        kind, n, T, L, dd, has_mask = (int(v) for v in np.frombuffer(view[:_HDR_BYTES], np.int32))
        if kind != _K_BATCH:
            raise ValueError(f"slot {slot} does not hold a batch (kind {kind})")
        off = _HDR_BYTES
        ib = n * T * L * 4
        idx = np.frombuffer(view[off:off + ib], np.int32).reshape(n, T, L).copy()
        off += ib
        dense = None
        if dd:
            dense = np.frombuffer(view[off:off + n * dd * 4], np.float32).reshape(n, dd).copy()
            off += n * dd * 4
        mask = None
        if has_mask:
            mask = np.frombuffer(view[off:off + n * T * L], np.bool_).reshape(n, T, L).copy()
        return idx, dense, mask

    def write_scores(self, slot: int, scores: np.ndarray):
        """Child: a request's (n, out_dim) f32 scores into its slot."""
        n, od = scores.shape
        self._write(slot, [_K_SCORES, n, 0, 0, 0, od],
                    scores.astype(np.float32, copy=False).tobytes(), "scores")

    def read_scores(self, slot: int) -> np.ndarray:
        view = self._view(slot)
        kind, n, _, _, _, od = (int(v) for v in np.frombuffer(view[:_HDR_BYTES], np.int32))
        if kind != _K_SCORES:
            raise ValueError(f"slot {slot} does not hold scores (kind {kind}): the engine "
                             f"answered without writing them")
        return np.frombuffer(view[_HDR_BYTES:_HDR_BYTES + n * od * 4],
                             np.float32).reshape(n, od).copy()

    # -- lifecycle -------------------------------------------------------------

    def close(self):
        self._shm.close()

    def unlink(self):
        if self._created:
            self._shm.unlink()
