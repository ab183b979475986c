"""The port's shared-memory runtime against the JAX package's, on the CPU:
the packets' 64 bytes, the reload fragments, the ring (one package writes,
the other reads, by name) and the blob arena's slots (the same in both
directions), and the ragged conversion."""

import os
import time

import numpy as np
import pytest

from deeprecsys_tpu.data import ragged as jax_ragged
from deeprecsys_tpu.runtime import blob_arena as jax_arena
from deeprecsys_tpu.runtime import shm_queue as jax_shm
from deeprecsys_tpu.serving import packets as jax_packets
from deeprecsys_tpu_torch.data import ragged
from deeprecsys_tpu_torch.runtime import Empty, blob_arena, native, shm_queue
from deeprecsys_tpu_torch.serving import packets

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native runtime not built (no g++)")

_PACKETS = {
    "request": dict(cls="ServiceRequest", batch_id=7, epoch=2, batch_size=33,
                    arrival_time=1.5e9 + 0.25, sub_id=3, total_sub_batches=5, exp_packet=True,
                    deadline=1.5e9 + 1.0, payload_slot=11),
    "request_no_slot": dict(cls="ServiceRequest", batch_id=0, batch_size=1),
    "response": dict(cls="ServiceResponse", consumer_id=4, epoch=1, batch_id=99, batch_size=64,
                     arrival_time=10.0, queue_start_time=10.5, queue_end_time=10.75,
                     inference_end_time=11.0, out_batch_size=64, sub_id=2,
                     total_sub_batches=3, exp_packet=False),
    "error_response": dict(cls="ServiceResponse", consumer_id=1, batch_id=5,
                           error_code=packets.ERR_DEADLINE),
    "reload_ack": dict(cls="ServiceResponse", consumer_id=2,
                       batch_id=packets.RELOAD_ACK_BATCH_ID, sub_id=17, exp_packet=True,
                       error_code=packets.ERR_RELOAD),
    "sentinel": None,
}


def _packet(module, spec):
    if spec is None:
        return None
    kw = dict(spec)
    return getattr(module, kw.pop("cls"))(**kw)


def _name(what: str) -> str:
    return f"drs_test_{what}_{os.getpid()}_{time.time_ns() % 1_000_000_000}"


@pytest.mark.parametrize("kind", list(_PACKETS))
def test_pack_packet_equals_jax(kind):
    """The same 64 bytes as the JAX package's for the same packet, and each
    package unpacks the other's."""
    got = shm_queue.pack_packet(_packet(packets, _PACKETS[kind]))
    want = jax_shm.pack_packet(_packet(jax_packets, _PACKETS[kind]))
    assert len(got) == 64 and got == want
    back = shm_queue.unpack_packet(want)
    if _PACKETS[kind] is None:
        assert back is None
        return
    ref = jax_shm.unpack_packet(got)
    assert type(back).__name__ == type(ref).__name__
    for f in ("batch_id", "epoch", "batch_size", "arrival_time", "sub_id",
              "total_sub_batches", "exp_packet"):
        assert getattr(back, f) == getattr(ref, f), f
    for f in ("deadline", "payload_slot", "consumer_id", "queue_start_time",
              "queue_end_time", "inference_end_time", "out_batch_size", "error_code"):
        if hasattr(ref, f):
            assert getattr(back, f) == getattr(ref, f), f


def test_payload_requests_refuse_the_ring():
    req = packets.ServiceRequest(batch_size=2, payload=object())
    with pytest.raises(TypeError, match="BlobArena"):
        shm_queue.pack_packet(req)


@pytest.mark.parametrize("n", [0, 1, 57, 58, 59, 200, 255 * 58])
def test_reload_fragments_equal_jax(n):
    path = ("/ckpt/" + "x" * n)[:max(n, 1)] if n else ""
    got = shm_queue.reload_fragments(path, gen=9)
    want = jax_shm.reload_fragments(path, gen=9)
    assert [(f.gen, f.seq, f.total, f.payload) for f in got] == \
        [(f.gen, f.seq, f.total, f.payload) for f in want]
    assert [shm_queue.pack_packet(f) for f in got] == [jax_shm.pack_packet(f) for f in want]
    assert b"".join(f.payload for f in got).decode() == path


def test_reload_fragments_refuse_what_jax_refuses():
    for fn in (shm_queue.reload_fragments, jax_shm.reload_fragments):
        with pytest.raises(ValueError, match="too long"):
            fn("/" + "y" * (255 * 58), gen=1)
        with pytest.raises(ValueError, match="one byte"):
            fn("/x", gen=256)


def test_ring_crosses_packages_by_name():
    """A ring the port creates is read by the JAX package's queue attached
    by name, and the other way round: the same native layout."""
    name = _name("ring")
    ring = shm_queue.ShmRingQueue(8, shm_name=name, create=True)
    try:
        peer = jax_shm.ShmRingQueue(8, shm_name=name, create=False)
        sent = [_packet(packets, _PACKETS[k]) for k in ("request", "response", "sentinel")]
        for p in sent:
            ring.put(p)
        assert ring.qsize() == 3
        got = [peer.get(timeout=5) for _ in sent]
        assert got[0].batch_id == 7 and got[0].payload_slot == 11
        assert got[1].consumer_id == 4 and got[1].queue_end_time == 10.75
        assert got[2] is None
        frag = jax_shm.reload_fragments("/a/b", gen=3)[0]
        peer.put(frag)
        back = ring.get(timeout=5)
        assert (back.gen, back.payload) == (3, b"/a/b")
        with pytest.raises(Empty):
            ring.get_nowait()
        t0 = time.monotonic()
        with pytest.raises(Empty):
            ring.get(timeout=0.1)
        assert time.monotonic() - t0 < 5
        peer.close()
    finally:
        ring.close()
        ring.unlink()
    with pytest.raises(ValueError, match="closed"):
        ring.put(None)


def test_private_ring_fills_and_drains():
    ring = shm_queue.ShmRingQueue(3)  # rounded up to 4 slots
    assert ring.capacity == 4
    for i in range(4):
        ring.put(packets.ServiceRequest(batch_id=i))
    with pytest.raises(TimeoutError, match="full"):
        ring.put(packets.ServiceRequest(batch_id=9), timeout=0.05)
    assert [ring.get(timeout=1).batch_id for _ in range(4)] == [0, 1, 2, 3]
    import queue

    with pytest.raises(queue.Empty):  # runtime.Empty is a queue.Empty
        ring.get_nowait()


@pytest.mark.parametrize("dense,mask", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blob_arena_slots_cross_packages(writer, dense, mask):
    """One package stages a batch, the other (attached by name) reads it and
    writes scores back, which the first reads: byte-equal slots."""
    n, T, L, dd, od = 5, 3, 4, 6, 2
    size = blob_arena.slot_bytes_for(n, T, L, dd if dense else 0, od, with_mask=mask)
    assert size == jax_arena.slot_bytes_for(n, T, L, dd if dense else 0, od, with_mask=mask)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1000, (n, T, L)).astype(np.int32)
    dns = rng.random((n, dd), dtype=np.float32) if dense else None
    msk = rng.random((n, T, L)) < 0.5 if mask else None
    scores = rng.random((n, od), dtype=np.float32)
    owner_mod, peer_mod = (blob_arena, jax_arena) if writer == "port" else (jax_arena, blob_arena)
    name = _name("arena")
    owner = owner_mod.BlobArena(name, 3, size, create=True)
    try:
        peer = peer_mod.BlobArena(name, 3, size, create=False)
        slot = owner.alloc()
        owner.write_batch(slot, idx, dns, mask=msk)
        got_idx, got_dense, got_mask = peer.read_batch(slot)
        np.testing.assert_array_equal(got_idx, idx)
        if dense:
            np.testing.assert_array_equal(got_dense, dns)
        else:
            assert got_dense is None
        if mask:
            np.testing.assert_array_equal(got_mask, msk)
        else:
            assert got_mask is None
        peer.write_scores(slot, scores)
        np.testing.assert_array_equal(owner.read_scores(slot), scores)
        owner.free(slot)
        peer.close()
    finally:
        owner.close()
        owner.unlink()


def test_blob_arena_guards_equal_jax():
    """Exhaustion, double free, out-of-range slots, oversize payloads and a
    scores read of a batch slot: refused as in the JAX package."""
    for mod in (blob_arena, jax_arena):
        name = _name("guards")
        a = mod.BlobArena(name, 2, mod.slot_bytes_for(2, 2, 2, 0, 1), create=True)
        try:
            s0, s1 = a.alloc(), a.alloc()
            assert a.in_flight() == 2
            with pytest.raises(RuntimeError, match="exhausted"):
                a.alloc()
            a.free(s0)
            with pytest.raises(RuntimeError, match="double free"):
                a.free(s0)
            with pytest.raises(ValueError, match="outside"):
                a.free(7)
            with pytest.raises(ValueError, match="exceeds"):
                a.write_batch(s1, np.zeros((4, 2, 2), np.int32), None)
            a.write_batch(s1, np.zeros((2, 2, 2), np.int32), None)
            with pytest.raises(ValueError, match="does not hold scores"):
                a.read_scores(s1)
            a.free(s1)
            assert a.in_flight() == 0
        finally:
            a.close()
            a.unlink()


def test_precise_sleep_releases_and_sleeps():
    t0 = time.perf_counter()
    native.precise_sleep_ns(3_000_000)
    assert time.perf_counter() - t0 >= 0.003


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_conversion_equals_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, L = 6, 4, 5
    lengths = rng.integers(0, L + 1, size=(B, T))
    values = rng.integers(0, 100, size=int(lengths.sum()))
    got_idx, got_mask = ragged.pad_csr(lengths, values, L)
    want_idx, want_mask = jax_ragged.pad_csr(lengths, values, L)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(ragged.lengths_to_mask(lengths.astype(np.float64), L),
                                  jax_ragged.lengths_to_mask(lengths, L))


@pytest.mark.parametrize("lengths,values", [
    ([[1.5, 0]], [3]),           # non-integral length
    ([[1, 1]], [2.5, 3]),        # non-integral id
    ([[6, 0]], [0] * 6),         # longer than L
    ([[-1, 2]], [0, 1]),         # negative
    ([[1, 1]], [0, 1, 2]),       # values do not match lengths
    ([1, 1], [0, 1]),            # not (B, T)
])
def test_ragged_refusals_equal_jax(lengths, values):
    with pytest.raises(ValueError) as want:
        jax_ragged.pad_csr(np.asarray(lengths), np.asarray(values), 5)
    with pytest.raises(ValueError) as got:
        ragged.pad_csr(np.asarray(lengths), np.asarray(values), 5)
    assert str(got.value) == str(want.value)
