"""Zero-copy packet queue over the native MPMC ring.

Counterpart of ``deeprecsys_tpu/runtime/shm_queue.py``, the same bytes:
a ``ServiceRequest``, ``ServiceResponse``, shutdown sentinel (None) or
reload-path fragment packs into one 64-byte slot, no pickling. The ring
lives in a private buffer (one process) or a ``multiprocessing.shared_memory``
segment (the cpu-mp engine processes' request, response, ready and control
rings; reference ``DeepRecSys.py:44-51``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
import time

from deeprecsys_tpu_torch.runtime import Empty, native
from deeprecsys_tpu_torch.serving.packets import ServiceRequest, ServiceResponse

# kind, exp, [consumer, epoch, batch, bsz, sub, total, out], 4 times, err, pad:
# exactly one 64-byte slot (the C++ side copies 64 bytes from the buffer).
# A request carries its deadline in the second double and its blob-arena
# slot in the consumer field; the error byte is a response's.
_FMT = "<BB7i4dBx"
assert struct.calcsize(_FMT) == 64

_K_REQUEST, _K_RESPONSE, _K_SENTINEL, _K_RELOAD = 0, 1, 2, 3

# A checkpoint path crosses in 58-byte utf-8 fragments (at most 255 of
# them): kind, gen, seq, total, frag_len, payload, pad. ``gen`` tags each
# fragment and the engine's ACK with the reload request they belong to.
_FMT_RELOAD = "<BBBBB58sx"
assert struct.calcsize(_FMT_RELOAD) == 64
_RELOAD_CHUNK = 58


@dataclasses.dataclass(slots=True)
class ReloadFragment:
    """One chunk of a checkpoint path on a control ring; an engine joins a
    ``gen``'s fragments in ``seq`` order and echoes ``gen`` in its ACK."""

    gen: int
    seq: int
    total: int
    payload: bytes


def reload_fragments(path: str, gen: int = 0) -> list[ReloadFragment]:
    """``path`` as the fragments of reload request ``gen`` (0-255)."""
    if not 0 <= gen <= 255:
        raise ValueError(f"gen must fit one byte; got {gen}")
    raw = path.encode()
    chunks = [raw[i:i + _RELOAD_CHUNK] for i in range(0, len(raw), _RELOAD_CHUNK)] or [b""]
    if len(chunks) > 255:
        raise ValueError(f"checkpoint path too long ({len(raw)} bytes)")
    return [ReloadFragment(gen=gen, seq=i, total=len(chunks), payload=c)
            for i, c in enumerate(chunks)]


def pack_packet(obj) -> bytes:
    if obj is None:
        return struct.pack(_FMT, _K_SENTINEL, 0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0.0, 0.0, 0.0, 0)
    if isinstance(obj, ReloadFragment):
        return struct.pack(_FMT_RELOAD, _K_RELOAD, obj.gen, obj.seq, obj.total,
                           len(obj.payload), obj.payload)
    if isinstance(obj, ServiceRequest):
        if obj.payload is not None:
            # Features cannot cross a 64-byte slot: they go through the
            # blob arena (payload_slot), never silently dropped.
            raise TypeError("payload-carrying requests cannot cross the POD ring; stage "
                            "the features in the BlobArena and set payload_slot (or use "
                            "in-process thread engines)")
        return struct.pack(
            _FMT, _K_REQUEST, int(obj.exp_packet), obj.payload_slot, obj.epoch, obj.batch_id,
            obj.batch_size, obj.sub_id, obj.total_sub_batches, 0,
            obj.arrival_time, obj.deadline, 0.0, 0.0, 0)
    if isinstance(obj, ServiceResponse):
        return struct.pack(
            _FMT, _K_RESPONSE, int(obj.exp_packet), obj.consumer_id, obj.epoch, obj.batch_id,
            obj.batch_size, obj.sub_id, obj.total_sub_batches, obj.out_batch_size,
            obj.arrival_time, obj.queue_start_time, obj.queue_end_time,
            obj.inference_end_time, obj.error_code)
    raise TypeError(f"cannot pack {type(obj)}")


def unpack_packet(buf: bytes):
    if buf[0] == _K_RELOAD:
        _, gen, seq, total, n, payload = struct.unpack_from(_FMT_RELOAD, buf)
        return ReloadFragment(gen=gen, seq=seq, total=total, payload=payload[:n])
    (kind, exp, consumer, epoch, batch_id, bsz, sub, total, out,
     arr, qs, qe, inf, err) = struct.unpack_from(_FMT, buf)
    if kind == _K_SENTINEL:
        return None
    if kind == _K_REQUEST:
        return ServiceRequest(batch_id=batch_id, epoch=epoch, batch_size=bsz,
                              arrival_time=arr, sub_id=sub, total_sub_batches=total,
                              exp_packet=bool(exp), deadline=qs, payload_slot=consumer)
    return ServiceResponse(consumer_id=consumer, epoch=epoch, batch_id=batch_id,
                           batch_size=bsz, arrival_time=arr, queue_start_time=qs,
                           queue_end_time=qe, inference_end_time=inf, out_batch_size=out,
                           sub_id=sub, total_sub_batches=total, exp_packet=bool(exp),
                           error_code=err)


class ShmRingQueue:
    """The subset of ``queue.Queue`` the serving stack uses (``put``,
    ``get``, ``get_nowait``, ``qsize``), over the native ring. With
    ``shm_name`` the ring is a shared-memory segment: ``create=True``
    makes it (the owner unlinks it), ``False`` attaches to it."""

    # A blocking get waits in chunks, so a close() is seen within 50 ms.
    _WAIT_CHUNK_NS = 50_000_000

    def __init__(self, capacity: int = 1024, shm_name: str | None = None, create: bool = True):
        self._lib = native.get_lib()
        # close() unmaps the ring, so a native call racing it would touch
        # freed memory: every native call of this process and close() hold
        # the lock (one bounded call at a time; other processes map the
        # ring on their own).
        self._op_lock = threading.Lock()
        cap = 1
        while cap < capacity:
            cap *= 2
        self.capacity = cap
        nbytes = int(self._lib.drs_ring_bytes(cap))
        self._shm = None
        if shm_name is None:
            # The header's head and tail are 64-byte aligned; a ctypes
            # buffer is not, so take 64 more bytes and round the base up.
            self._buf = ctypes.create_string_buffer(nbytes + 64)
            self._mem = ctypes.c_void_p((ctypes.addressof(self._buf) + 63) & ~63)
            self._lib.drs_ring_init(self._mem, cap)
        else:
            from multiprocessing import shared_memory

            self._shm = shared_memory.SharedMemory(name=shm_name, create=create,
                                                   size=nbytes if create else 0)
            self._mem = ctypes.c_void_p(ctypes.addressof(ctypes.c_char.from_buffer(self._shm.buf)))
            if create:
                self._lib.drs_ring_init(self._mem, cap)
        self.name = shm_name

    def _checked_mem(self):
        # The caller holds _op_lock; close() sets _mem to None under it.
        if self._mem is None:
            raise ValueError("ring is closed")
        return self._mem

    def put(self, obj, timeout: float | None = None):
        data = pack_packet(obj)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._op_lock:
                if self._lib.drs_ring_push(self._checked_mem(), data) == 0:
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("ring full")
            time.sleep(0.00005)

    def get(self, timeout: float | None = None):
        out = ctypes.create_string_buffer(64)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is None:
                t_ns = self._WAIT_CHUNK_NS
            else:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise Empty()
                t_ns = min(int(left * 1e9), self._WAIT_CHUNK_NS)
            with self._op_lock:
                rc = self._lib.drs_ring_pop_wait(self._checked_mem(), out, t_ns)
            if rc == 0:
                return unpack_packet(out.raw)

    def get_nowait(self):
        out = ctypes.create_string_buffer(64)
        with self._op_lock:
            if self._lib.drs_ring_pop(self._checked_mem(), out) != 0:
                raise Empty()
        return unpack_packet(out.raw)

    def qsize(self) -> int:
        with self._op_lock:
            return int(self._lib.drs_ring_approx_size(self._checked_mem()))

    def close(self):
        if self._shm is not None:
            with self._op_lock:
                self._mem = None
                self._shm.close()

    def unlink(self):
        if self._shm is not None:
            self._shm.unlink()
