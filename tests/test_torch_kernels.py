"""K1, K3, the int8 lookups K1-int8 and K4, the training kernels K1b, K5,
K3b and K10, and the hot/cold lookup K6 against their plain versions on a
CUDA card.

These tests need a card; without one they skip. The file imports no JAX,
so it runs where only torch is installed (``--noconftest`` skips
``tests/conftest.py``, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Tolerances:
- K1 (``ops.embedding.pooled_tolerance``): both versions convert rows to
  the compute dtype and sum in f32, so they differ only in summation
  order: |a - b| <= L * 2^-23 * sum|rows|, plus 1 bf16 ulp of the larger
  value for bf16 outputs.
- K1-int8: bit for bit (an exact int32 sum, then the same f32 multiply
  and rounding). K4 (``ops.embedding.rowwise_tolerance``): the same
  products, sums in other orders, so K1's bound on the dequantized rows.
- K3: each step, recomputed from the kernel's own previous state, within
  ``ops.rnn.rnn_scan_tolerance`` (the f32 slack of the dot, tanh's error,
  one ulp of the output dtype; frozen rows exact); the free-running scans
  within 1e-5 (f32) and 2^-7 (bf16) of the plain loop (chip_smoke.py
  states why).
- K1b (``ops.embedding.backward_tolerance``) and K5
  (``ops.sparse_adagrad.sparse_adagrad_tolerance``): the kernels add each
  row's terms with atomics in no fixed order, so a row of n adds agrees
  within n roundings of its running sum (bf16 tables: of the bf16 adds);
  K5's general instance (d 24, 48, 100 here) also sums a bag's squares in
  column order, within (d + 1) * 2^-23 of torch.mean relatively.
- K10 (``ops.optimizer.optimizer_update``): bit for bit its plain version
  (the same f32 operations, each rounded as the eager ops round them).
- K3b: the reverse scan in f32 against its plain loop, each with its own
  order of the 64-term dot, carried over T steps: within 1e-5 of the
  largest |delta| (``RNN_BACKWARD_RTOL``; chip_smoke.py measures it); a
  misaligned view bit for bit against an aligned copy (the same kernel).
- K6: per-table int8 bit for bit against its plain version and K1-int8 on
  the same ids; float and row-wise within ``hotcold_tolerance`` of the
  plain version and ``pooled_tolerance``/``rowwise_tolerance`` of K1/K4
  (the same rows, summed in another f32 order).
- The mesh modes (the window of K1, K1-int8 and K4; K6 on a shard): the
  int32 partials bit for bit, the f32 ones within the same tolerances
  given the window; the shards' partials combined against the direct
  kernel as above, and K1's full window rounded once bit for bit K1.
- The training windows (K1b's and K5's, on shards of 1, 2 and 4): each
  shard within ``backward_tolerance``/``sparse_adagrad_tolerance`` with
  ``window=`` of its plain version (a bf16 shard's rows, each rounded
  once, within the f32 order bound plus one bf16 ulp: on rows of ~16
  adds a rounding at each add misses it); K1b's windows concatenated also
  within ``backward_tolerance`` of the direct K1b, and the autograd of
  ``embedding_bag_shard`` launches K1b's window once a shard.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch.ops import (
    embedding_bag, embedding_bag_backward, embedding_bag_backward_reference,
    embedding_bag_int8, embedding_bag_int8_reference, embedding_bag_int8_rowwise,
    embedding_bag_int8_rowwise_reference, embedding_bag_reference, optimizer_update,
    optimizer_update_reference, rnn_scan, rnn_scan_backward, rnn_scan_backward_reference,
    rnn_scan_reference, sparse_adagrad_step, sparse_adagrad_step_reference,
    sparse_adagrad_step_shard)
from deeprecsys_tpu_torch.ops.embedding import (
    backward_tolerance, pooled_tolerance, rowwise_tolerance)
from deeprecsys_tpu_torch.ops.rnn import rnn_scan_tolerance
from deeprecsys_tpu_torch.ops.sparse_adagrad import k5_launch_plan, sparse_adagrad_tolerance

RNN_BACKWARD_RTOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("table_dt,compute_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_kernel_matches_reference(cuda, table_dt, compute_dt, d, masked):
    rows = (5000, 300, 70000)
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((sum(rows), d), generator=g, device=cuda).to(table_dt)
    offsets = torch.tensor(np.cumsum((0,) + rows[:-1]), dtype=torch.int32, device=cuda)
    B, L = 37, 23
    indices = torch.stack([torch.randint(0, n, (B, L), generator=g, device=cuda)
                           for n in rows], dim=1).to(torch.int32)
    mask = (torch.rand(indices.shape, generator=g, device=cuda) < 0.7) if masked else None
    before = embedding_bag.kernel_launches
    got = embedding_bag(table, offsets, indices, compute_dtype=compute_dt, mask=mask)
    torch.cuda.synchronize()
    assert embedding_bag.kernel_launches == before + 1
    want = embedding_bag_reference(table, offsets, indices, compute_dtype=compute_dt, mask=mask)
    assert got.dtype == compute_dt and got.shape == (B, 3, d)
    tol = pooled_tolerance(got, want, table, offsets, indices, mask)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_kernel_on_a_side_stream_follows_the_copy_of_its_ids(cuda):
    """K1 launches on the calling thread's current stream, as a serving
    engine's stream: under a side stream it runs after that stream's
    pinned, non-blocking copy of its ids (held back by a long sleep
    kernel), and gives the default stream's result. Were it launched on
    the default stream it would read the zeros the ids buffer held."""
    rows = (5000, 300, 70000)
    g = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn((sum(rows), 32), generator=g, device=cuda).bfloat16()
    offsets = torch.tensor(np.cumsum((0,) + rows[:-1]), dtype=torch.int32, device=cuda)
    ids = torch.stack([torch.randint(1, n, (64, 20), generator=g, device=cuda)
                       for n in rows], dim=1).to(torch.int32)
    want = embedding_bag(table, offsets, ids)
    host = ids.cpu().pin_memory()
    dev_ids = torch.zeros_like(ids)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)  # ~tens of ms of one busy block
        dev_ids.copy_(host, non_blocking=True)
        got = embedding_bag(table, offsets, dev_ids)
    side.synchronize()
    assert torch.equal(got, want)
    zeros = embedding_bag(table, offsets, torch.zeros_like(ids))
    assert not torch.equal(want, zeros)


def test_kernel_rejects_misaligned_table(cuda):
    base = torch.zeros((100 * 32 + 4,), dtype=torch.bfloat16, device=cuda)
    table = base[4:].view(100, 32)  # starts 8 bytes into the allocation
    offsets = torch.zeros((1,), dtype=torch.int32, device=cuda)
    indices = torch.zeros((2, 1, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        embedding_bag(table, offsets, indices)


@pytest.mark.parametrize("B,T,L,rows", [
    (512, 27, 1, 20000),   # wnd's pooling: one id a bag
    (16, 254, 3, 5000),    # din's table count
])
def test_kernel_at_zoo_extremes(cuda, B, T, L, rows):
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn((rows * T, 32), generator=g, device=cuda).bfloat16()
    offsets = torch.arange(T, dtype=torch.int32, device=cuda) * rows
    indices = torch.randint(0, rows, (B, T, L), generator=g, device=cuda).to(torch.int32)
    got = embedding_bag(table, offsets, indices)
    torch.cuda.synchronize()
    want = embedding_bag_reference(table, offsets, indices)
    tol = pooled_tolerance(got, want, table, offsets, indices)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def _int8_inputs(cuda, rows, d, B, L, seed, masked):
    """Random int8 tables of ``rows`` (per-table: q and positive scales;
    row-wise: (R, d + 4) rows with positive f32 scales in their last 4
    bytes), ids and a mask with bag (0, 0) masked out entirely."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    R, T = sum(rows), len(rows)
    offsets = torch.tensor(np.cumsum((0,) + tuple(rows[:-1])), dtype=torch.int32, device=cuda)
    q = torch.randint(-127, 128, (R, d), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand((T,), generator=g, device=cuda) * 1e-2 + 1e-4
    row_scale = torch.rand((R,), generator=g, device=cuda) * 1e-2 + 1e-4
    qrows = torch.cat([q, row_scale.view(torch.int8).reshape(R, 4)], dim=1)
    indices = torch.stack([torch.randint(0, n, (B, L), generator=g, device=cuda)
                           for n in rows], dim=1).to(torch.int32)
    mask = None
    if masked:
        mask = torch.rand(indices.shape, generator=g, device=cuda) < 0.7
        mask[0, 0] = False
    return q, scale, qrows, offsets, indices, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("compute_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("B,L", [(37, 23), (1, 1), (7, 3), (33, 5), (5, 8), (16, 80), (3, 120)])
def test_int8_kernels_match_reference(cuda, B, L, d, compute_dt, masked):
    """K1-int8 equals its plain version bit for bit; K4 agrees within
    rowwise_tolerance. Every mapping the two plans pick, B * T not a
    multiple of the bags a warp holds."""
    q, scale, qrows, offsets, indices, mask = _int8_inputs(
        cuda, (5000, 300, 70000), d, B, L, seed=L + d, masked=masked)
    before = (embedding_bag_int8.kernel_launches, embedding_bag_int8_rowwise.kernel_launches)
    got = embedding_bag_int8(q, scale, offsets, indices, compute_dtype=compute_dt, mask=mask)
    got_rw = embedding_bag_int8_rowwise(qrows, offsets, indices, compute_dtype=compute_dt,
                                        mask=mask)
    torch.cuda.synchronize()
    assert (embedding_bag_int8.kernel_launches, embedding_bag_int8_rowwise.kernel_launches) == (
        before[0] + 1, before[1] + 1)
    want = embedding_bag_int8_reference(q, scale, offsets, indices, compute_dtype=compute_dt,
                                        mask=mask)
    assert got.dtype == got_rw.dtype == compute_dt and got.shape == got_rw.shape == (B, 3, d)
    assert torch.equal(got, want)
    want_rw = embedding_bag_int8_rowwise_reference(qrows, offsets, indices,
                                                   compute_dtype=compute_dt, mask=mask)
    tol = rowwise_tolerance(got_rw, want_rw, qrows, offsets, indices, mask)
    assert bool(((got_rw.float() - want_rw.float()).abs() <= tol).all())
    if masked:
        assert not got[0, 0].any() and not got_rw[0, 0].any()


def test_int8_kernels_reject_misaligned_tables(cuda):
    q, scale, qrows, offsets, indices, _ = _int8_inputs(cuda, (50,), 32, 2, 3, 0, False)
    base = torch.zeros((50 * 32 + 8,), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        embedding_bag_int8(base[8:].view(50, 32), scale, offsets, indices)
    base = torch.zeros((50 * 36 + 2,), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        embedding_bag_int8_rowwise(base[2:].view(50, 36), offsets, indices)
    # A slice that starts at row 1 is 4-byte aligned: every row is.
    got = embedding_bag_int8_rowwise(qrows[1:], offsets, indices)
    want = embedding_bag_int8_rowwise_reference(qrows[1:], offsets, indices)
    assert bool(((got - want).abs() <= rowwise_tolerance(got, want, qrows[1:], offsets,
                                                         indices)).all())


def _check_k4(qrows, offsets, indices, compute_dt=torch.float32, mask=None):
    got = embedding_bag_int8_rowwise(qrows, offsets, indices, compute_dtype=compute_dt,
                                     mask=mask)
    torch.cuda.synchronize()
    want = embedding_bag_int8_rowwise_reference(qrows, offsets, indices,
                                                compute_dtype=compute_dt, mask=mask)
    tol = rowwise_tolerance(got, want, qrows, offsets, indices, mask)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("compute_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(37, 23), (7, 3)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_k4_at_every_row_phase(cuda, phase, d, B, L, compute_dt):
    """K4 loads a row as the 16-byte-aligned chunks that cover it and picks
    its words by the row's phase (address % 16) / 4. Row r of a table that
    starts on a 16-byte boundary has phase r % 4 ((d + 4) % 16 == 4), so
    ids of one residue read rows of one phase only: here every phase, at
    both widths, with a warp a bag (L = 23) and a slot a bag (L = 3)."""
    rows = (4000, 400, 8000)
    _, _, qrows, offsets, _, mask = _int8_inputs(cuda, rows, d, B, L, seed=phase, masked=True)
    assert qrows.data_ptr() % 16 == 0
    g = torch.Generator(device=cuda).manual_seed(10 + phase)
    indices = torch.stack([torch.randint(0, n // 4, (B, L), generator=g, device=cuda) * 4 + phase
                           for n in rows], dim=1).to(torch.int32)
    _check_k4(qrows, offsets, indices, compute_dt)
    _check_k4(qrows, offsets, indices, compute_dt, mask)


@pytest.mark.parametrize("start", [0, 4, 8, 12])
@pytest.mark.parametrize("d", [32, 64])
def test_k4_on_a_table_that_ends_its_allocation(cuda, d, start):
    """The last row of the table ends where its storage ends, the end of a
    32 MiB allocation of its own, and the table starts ``start`` bytes past
    a 16-byte boundary (a 4-byte boundary only, for start 4, 8, 12); the
    ids read the last 64 rows of the last table, every phase among them.
    K4's chunks over-read a row only inside the 16-byte granules that hold
    its bytes, so none passes the end of the allocation."""
    rb, size = d + 4, 1 << 25
    n_last = 20000 + (-(start // 4)) % 4  # (size - R * rb) % 16 == start
    rows = (3000, n_last)
    R = sum(rows)
    assert (size - R * rb) % 16 == start
    _, _, src, offsets, indices, _ = _int8_inputs(cuda, rows, d, 33, 20, seed=start + d,
                                                  masked=False)
    torch.cuda.empty_cache()
    buf = torch.empty((size,), dtype=torch.int8, device=cuda)
    qrows = buf[size - R * rb:].view(R, rb)
    qrows.copy_(src)
    assert qrows.data_ptr() % 16 == start
    assert qrows.data_ptr() + qrows.numel() == buf.data_ptr() + buf.numel()
    g = torch.Generator(device=cuda).manual_seed(start)
    indices[:, 1] = (n_last - 1 - torch.randint(0, 64, indices[:, 1].shape, generator=g,
                                                device=cuda)).to(torch.int32)
    _check_k4(qrows, offsets, indices)
    _check_k4(qrows, offsets, indices, torch.bfloat16)
    # The same rows from a tensor whose storage is exactly the table.
    exact = torch.empty((R * rb + start,), dtype=torch.int8, device=cuda)[start:].view(R, rb)
    exact.copy_(src)
    _check_k4(exact, offsets, indices)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("value", [-128, 127, None])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("L", [257, 258, 300, 5000])
def test_int8_kernel_long_bags_bit_for_bit(cuda, L, d, value, masked):
    """Bags of 257, 258, 300 and 5000 rows (past any 16-bit or 8-bit count
    of rows a lane might keep) whose values are all -128, all 127 or
    random, masked and not: K1-int8 against its plain version bit for bit
    (and, unscaled, equal to value * L), K4 on the same rows within
    rowwise_tolerance."""
    rows = (6000, 300)
    q, scale, qrows, offsets, indices, mask = _int8_inputs(cuda, rows, d, 3, L, seed=L + d,
                                                           masked=masked)
    if value is not None:
        q.fill_(value)
        qrows[:, :d] = value
    for compute_dt in (torch.float32, torch.bfloat16):
        got = embedding_bag_int8(q, scale, offsets, indices, compute_dtype=compute_dt,
                                 mask=mask)
        torch.cuda.synchronize()
        want = embedding_bag_int8_reference(q, scale, offsets, indices,
                                            compute_dtype=compute_dt, mask=mask)
        assert torch.equal(got, want)
        _check_k4(qrows, offsets, indices, compute_dt, mask)
    if value is not None and not masked:
        sums = embedding_bag_int8(q, torch.ones_like(scale), offsets, indices)
        assert bool((sums == value * L).all())


def _rnn_inputs(cuda, T, B, w_dt, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lens = torch.randint(0, T + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    lens[:2] = torch.tensor([0, T], dtype=torch.int32)[:B]
    return (torch.randn((T, B, 64), generator=g, device=cuda),
            (torch.randn((64, 64), generator=g, device=cuda) / 8).to(w_dt),
            (torch.randn((64,), generator=g, device=cuda) * 0.1).to(w_dt),
            torch.randn((B, 64), generator=g, device=cuda) * 0.5, lens)


@pytest.mark.parametrize("use_lens", [False, True])
@pytest.mark.parametrize("use_h0", [False, True])
@pytest.mark.parametrize("w_dt,out_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("T,B", [(40, 512), (7, 5)])
def test_rnn_scan_kernel_matches_plain_loop(cuda, T, B, w_dt, out_dt, use_h0, use_lens):
    xproj, w, b, h0, lens = _rnn_inputs(cuda, T, B, w_dt)
    h0 = h0 if use_h0 else None
    lens = lens if use_lens else None
    before = rnn_scan.kernel_launches
    got, last = rnn_scan(xproj, w, b, out_dt, h0=h0, seq_lengths=lens)
    torch.cuda.synchronize()
    assert rnn_scan.kernel_launches == before + 1
    assert got.dtype == last.dtype == out_dt and got.shape == (T, B, 64)
    step, tol = rnn_scan_tolerance(got, xproj, w, b, h0=h0, seq_lengths=lens)
    assert bool(((got.float() - step).abs() <= tol).all())
    want, want_last = rnn_scan_reference(xproj, w, b, out_dt, h0=h0, seq_lengths=lens)
    atol = 1e-5 if out_dt == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(last.float(), want_last.float(), rtol=0, atol=atol)
    if use_lens:  # row 0 has length 0: it keeps its initial state throughout
        start = h0[0].to(out_dt) if use_h0 else torch.zeros(64, dtype=out_dt, device=cuda)
        assert torch.equal(got[:, 0], start.expand(T, 64))


def test_rnn_scan_kernel_rejects_other_hidden_sizes(cuda):
    with pytest.raises(ValueError, match="at most 1024"):
        rnn_scan(torch.zeros((3, 2, 1025), device=cuda), torch.zeros((1025, 1025), device=cuda),
                 torch.zeros(1025, device=cuda), torch.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d,dt", [(32, torch.bfloat16), (64, torch.bfloat16),
                                  (32, torch.float32), (64, torch.float32)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 20, 80, 120])
@pytest.mark.parametrize("B,T", [(1, 1), (7, 3), (33, 5)])
def test_kernel_at_launch_plan_edges(cuda, B, T, L, d, dt, masked):
    """Every mapping k1_launch_plan picks: B * T = 1 and not a multiple of
    the bags a warp holds; with a mask, bag (0, 0) is masked out entirely."""
    rows = 300
    g = torch.Generator(device=cuda).manual_seed(L)
    table = torch.randn((rows * T, d), generator=g, device=cuda).to(dt)
    offsets = torch.arange(T, dtype=torch.int32, device=cuda) * rows
    indices = torch.randint(0, rows, (B, T, L), generator=g, device=cuda).to(torch.int32)
    mask = None
    if masked:
        mask = torch.rand((B, T, L), generator=g, device=cuda) < 0.6
        mask[0, 0] = False
    got = embedding_bag(table, offsets, indices, mask=mask)
    torch.cuda.synchronize()
    want = embedding_bag_reference(table, offsets, indices, mask=mask)
    tol = pooled_tolerance(got, want, table, offsets, indices, mask)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    if masked:
        assert not got[0, 0].any()


@pytest.mark.parametrize("use_h0", [False, True])
@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B", [(1, 1), (1, 5), (40, 5), (40, 7), (9, 130), (41, 133)])
def test_rnn_scan_kernel_plan_edges(cuda, T, B, out_dt, use_h0):
    """T = 1 and T = 40 (several cp.async chunks, one not full), seq_lengths
    holding 0 and T, B = 1, and B past the card's SM count."""
    xproj, w, b, h0, lens = _rnn_inputs(cuda, T, B, out_dt, seed=T + B)
    h0 = h0 if use_h0 else None
    got, last = rnn_scan(xproj, w, b, out_dt, h0=h0, seq_lengths=lens)
    torch.cuda.synchronize()
    step, tol = rnn_scan_tolerance(got, xproj, w, b, h0=h0, seq_lengths=lens)
    assert bool(((got.float() - step).abs() <= tol).all())
    want, want_last = rnn_scan_reference(xproj, w, b, out_dt, h0=h0, seq_lengths=lens)
    atol = 1e-5 if out_dt == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(last.float(), want_last.float(), rtol=0, atol=atol)
    start = h0[0].to(out_dt) if use_h0 else torch.zeros(64, dtype=out_dt, device=cuda)
    assert torch.equal(got[:, 0], start.expand(T, 64))  # lens[0] == 0


# ------------------------------------------------------------ training kernels

def _dup_inputs(cuda, B, T, L, rows, d, seed):
    """Ids from few rows a table, so rows repeat many times in a batch."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    offsets = torch.arange(T, dtype=torch.int32, device=cuda) * rows
    indices = torch.randint(0, rows, (B, T, L), generator=g, device=cuda).to(torch.int32)
    grad = torch.randn((B, T, d), generator=g, device=cuda)
    return g, offsets, indices, grad


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("B,T,L,rows", [(37, 3, 23, 50), (128, 8, 80, 2000), (5, 2, 1, 3)])
def test_embedding_bag_backward_kernel_matches_reference(cuda, B, T, L, rows, d, g_dt, masked):
    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=L + d)
    grad = grad.to(g_dt)
    mask = (torch.rand((B, T, L), generator=gen, device=cuda) < 0.7) if masked else None
    before = embedding_bag_backward.kernel_launches
    got = embedding_bag_backward(grad, offsets, indices, T * rows, mask=mask)
    torch.cuda.synchronize()
    assert embedding_bag_backward.kernel_launches == before + 1
    want = embedding_bag_backward_reference(grad, offsets, indices, T * rows, mask=mask)
    tol = backward_tolerance(grad, offsets, indices, T * rows, mask)
    assert got.dtype == torch.float32 and got.shape == (T * rows, d)
    assert bool(((got - want).abs() <= tol).all())


def test_embedding_bag_autograd_launches_k1b_and_not_under_inference(cuda):
    gen, offsets, indices, _ = _dup_inputs(cuda, 16, 3, 7, 40, 32, seed=3)
    table = torch.randn((120, 32), generator=gen, device=cuda).requires_grad_(True)
    before = embedding_bag_backward.kernel_launches
    out = embedding_bag(table, offsets, indices)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert embedding_bag_backward.kernel_launches == before + 1
    want = embedding_bag_backward_reference(2 * out.detach(), offsets, indices, 120)
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        assert embedding_bag(table, offsets, indices).grad_fn is None
    assert embedding_bag(table.detach(), offsets, indices).grad_fn is None


@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 32, 48, 64, 100])  # 24, 48, 100: the general instance
@pytest.mark.parametrize("B,T,L,rows", [(37, 3, 23, 50), (128, 8, 80, 2000), (5, 2, 1, 3)])
def test_sparse_adagrad_kernel_matches_reference(cuda, B, T, L, rows, d, table_dt, g_dt):
    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=L + 2 * d)
    grad = (grad * 1e-2).to(g_dt)
    table0 = (torch.rand((T * rows, d), generator=gen, device=cuda) - 0.5).to(table_dt)
    acc0 = torch.rand((T * rows,), generator=gen, device=cuda) * 1e-4
    table, acc = table0.clone(), acc0.clone()
    before = sparse_adagrad_step.kernel_launches
    sparse_adagrad_step(table, acc, offsets, indices, grad, 0.1)
    torch.cuda.synchronize()
    assert sparse_adagrad_step.kernel_launches == before + 1
    want_t, want_a = table0.clone(), acc0.clone()
    sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1)
    tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, indices, grad, 0.1)
    assert bool(((acc - want_a).abs() <= acc_tol).all())
    assert bool(((table.float() - want_t.float()).abs() <= tol).all())


def _check_k5(table0, acc0, offsets, indices, grad):
    table, acc = table0.clone(), acc0.clone()
    before = sparse_adagrad_step.kernel_launches
    sparse_adagrad_step(table, acc, offsets, indices, grad, 0.1)
    torch.cuda.synchronize()
    assert sparse_adagrad_step.kernel_launches == before + 1
    want_t, want_a = table0.clone(), acc0.clone()
    sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1)
    tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, indices, grad, 0.1)
    assert bool(((acc - want_a).abs() <= acc_tol).all())
    assert bool(((table.float() - want_t.float()).abs() <= tol).all())


@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("B,T,L,rows", [
    (37, 3, 1, 50), (129, 43, 1, 500), (9, 5, 3, 4), (7, 3, 5, 20), (11, 2, 17, 9),
    (3, 2, 33, 30), (7, 3, 200, 40), (1, 1, 1, 1)])
def test_sparse_adagrad_kernel_at_plan_edges(cuda, B, T, L, rows, d, table_dt, g_dt):
    """The plan's lanes a bag (1 to 32: several short bags a warp, bag
    counts that are no multiple of them, a warp a bag of 200 slots) and
    every lanes-a-slot mapping (4 to 16 lanes a row), on rows that repeat."""
    plan = k5_launch_plan(B * T, L, d, table_dt, g_dt)
    g_bytes = 4 if g_dt == torch.float32 else 2
    assert plan.lanes_per_bag == min(32, max(1 << (L - 1).bit_length(), d * g_bytes // 16))
    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=B + L + d)
    table0 = (torch.rand((T * rows, d), generator=gen, device=cuda) - 0.5).to(table_dt)
    acc0 = torch.rand((T * rows,), generator=gen, device=cuda) * 1e-4
    _check_k5(table0, acc0, offsets, indices, (grad * 1e-2).to(g_dt))


def test_sparse_adagrad_kernel_takes_an_unaligned_gradient_and_rejects_an_unaligned_table(cuda):
    gen, offsets, indices, grad = _dup_inputs(cuda, 7, 3, 5, 20, 32, seed=5)
    buf = torch.randn((7 * 3 * 32 + 1,), generator=gen, device=cuda) * 1e-2
    g_view = buf[1:].view(7, 3, 32)  # contiguous, 4 bytes past a 16-byte boundary
    table0 = torch.rand((60, 32), generator=gen, device=cuda) - 0.5
    acc0 = torch.rand((60,), generator=gen, device=cuda) * 1e-4
    _check_k5(table0, acc0, offsets, indices, g_view)
    tbuf = torch.zeros((60 * 32 + 1,), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        sparse_adagrad_step(tbuf[1:].view(60, 32), acc0.clone(), offsets, indices, grad, 0.1)


def _k10_case(cuda, name, dt, sizes, seed, unaligned=False):
    """Leaves of ``sizes`` elements (each one element past a 16-byte
    boundary if ``unaligned``), gradients over seven decades, the
    trainer's initial state."""
    from deeprecsys_tpu_torch.train import make_optimizer

    g = torch.Generator(device=cuda).manual_seed(seed)
    skip = 1 if unaligned else 0
    params = [torch.randn((n + skip,), generator=g, device=cuda).to(dt)[skip:] for n in sizes]
    grads = [(torch.randn((n,), generator=g, device=cuda)
              * 10.0 ** torch.randint(-6, 1, (n,), generator=g, device=cuda)).to(dt)
             for n in sizes]
    st = make_optimizer(name, 0.05).init(params)
    states = [] if st is None else [st] if name == "adagrad" else [st["mu"], st["nu"]]
    return params, grads, states


def _k10_bit_for_bit(name, params, grads, states, count):
    count = torch.tensor(count, dtype=torch.int32, device=params[0].device)
    ps, ss = [p.clone() for p in params], [[t.clone() for t in s] for s in states]
    before = optimizer_update.kernel_launches
    optimizer_update(name, ps, grads, ss, 0.05, count)
    torch.cuda.synchronize()
    assert optimizer_update.kernel_launches == before + 1
    optimizer_update_reference(name, params, grads, states, 0.05, count)
    for a, b in zip(ps + [t for s in ss for t in s], params + [t for s in states for t in s]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_update_kernel_is_bit_for_bit(cuda, name, dt, unaligned):
    """Odd sizes (one element, under a vector, a vector and a tail, past
    the 65,536-element chunk), two steps (adam's bias corrections at counts
    1 and 2, then a step at count 1000: the kernel's powf against
    torch.pow), aligned leaves and leaves one element past a 16-byte
    boundary (the element-by-element path)."""
    params, grads, states = _k10_case(cuda, name, dt, (1, 3, 7, 4097, 65536 * 2 + 5, 1000003),
                                      seed=3, unaligned=unaligned)
    for count in (1, 2, 1000):
        _k10_bit_for_bit(name, params, grads, states, count)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_update_kernel_over_many_leaves_of_both_dtypes(cuda, name):
    """45 leaves (two launches of at most 40 leaves in one C call) of f32
    and bf16 mixed (one launch a dtype, one count a call)."""
    p32, g32, s32 = _k10_case(cuda, name, torch.float32, [17 * k + 1 for k in range(30)], 4)
    p16, g16, s16 = _k10_case(cuda, name, torch.bfloat16, [33 * k + 5 for k in range(15)], 5)
    _k10_bit_for_bit(name, p32 + p16, g32 + g16, [a + b for a, b in zip(s32, s16)], 1)


def test_optimizer_update_kernel_rejects_a_strided_param(cuda):
    p = torch.zeros((8, 8), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        optimizer_update("sgd", [p], [torch.zeros_like(p)], [], 0.1)


def _rnn_backward_inputs(cuda, T, B, w_dt, seed):
    xproj, w, b, h0, lens = _rnn_inputs(cuda, T, B, w_dt, seed)
    all_h, _ = rnn_scan_reference(xproj, w, b, torch.float32, h0=h0)
    prev = torch.cat([h0[None], all_h[:-1]])
    y = torch.tanh((xproj + prev @ w.float()) + b.float())
    gh = torch.randn((T, B, 64), generator=torch.Generator(device=cuda).manual_seed(seed),
                     device=cuda)
    return y, gh, w, lens


@pytest.mark.parametrize("use_lens", [False, True])
@pytest.mark.parametrize("w_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B", [(40, 512), (7, 5), (1, 3), (41, 133)])
def test_rnn_scan_backward_kernel_matches_plain_loop(cuda, T, B, w_dt, use_lens):
    y, gh, w, lens = _rnn_backward_inputs(cuda, T, B, w_dt, seed=T + B)
    lens = lens if use_lens else None
    before = rnn_scan_backward.kernel_launches
    delta, dh0 = rnn_scan_backward(y, gh, w, lens)
    torch.cuda.synchronize()
    assert rnn_scan_backward.kernel_launches == before + 1
    want_d, want_h = rnn_scan_backward_reference(y, gh, w, lens)
    scale = float(want_d.abs().max())
    torch.testing.assert_close(delta, want_d, rtol=0, atol=RNN_BACKWARD_RTOL * scale)
    torch.testing.assert_close(dh0, want_h, rtol=0, atol=RNN_BACKWARD_RTOL * max(
        scale, float(want_h.abs().max())))
    if use_lens:  # row 0 has length 0: no step is alive, the gradient passes through
        assert not delta[:, 0].any()
        torch.testing.assert_close(dh0[0], gh[:, 0].sum(0), rtol=1e-5, atol=1e-5)


def _k3b_ring() -> int:
    """The steps K3b's ring holds in the shipped instance: its chunks times
    their steps (``csrc/rnn_scan_backward.cu``)."""
    src = (Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc"
           / "rnn_scan_backward.cu").read_text()
    return int(re.search(r"static constexpr int kChunk = (\d+);", src).group(1)) * int(
        re.search(r"static constexpr int kRing = (\d+);", src).group(1))


@pytest.mark.parametrize("lens_case", ["none", "all 0", "all T", "mixed"])
@pytest.mark.parametrize("w_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 128, 513])
@pytest.mark.parametrize("T_case", ["1", "ring - 1", "ring + 1", "40"])
def test_rnn_scan_backward_kernel_at_ring_edges(cuda, T_case, B, w_dt, lens_case):
    """K3b where its ring could slip: T of one step, one under and one past
    the ring (its first fill, the first slot refilled), DIEN's 40; one row,
    the trainer's batch and one past 512; every row frozen, none frozen,
    mixed lengths (row 0 of length 0): within 1e-5 of the largest |delta|."""
    ring = _k3b_ring()
    T = {"1": 1, "ring - 1": ring - 1, "ring + 1": ring + 1, "40": 40}[T_case]
    y, gh, w, lens = _rnn_backward_inputs(cuda, T, B, w_dt, seed=T * 3 + B)
    lens = {"none": None, "all 0": torch.zeros_like(lens), "all T": torch.full_like(lens, T),
            "mixed": lens}[lens_case]
    delta, dh0 = rnn_scan_backward(y, gh, w, lens)
    torch.cuda.synchronize()
    want_d, want_h = rnn_scan_backward_reference(y, gh, w, lens)
    scale = max(float(want_d.abs().max()), float(want_h.abs().max()))
    torch.testing.assert_close(delta, want_d, rtol=0, atol=RNN_BACKWARD_RTOL * scale)
    torch.testing.assert_close(dh0, want_h, rtol=0, atol=RNN_BACKWARD_RTOL * scale)
    if lens_case == "all 0":  # every step frozen: the gradient passes through, summed
        assert not delta.any()
        torch.testing.assert_close(dh0, gh.sum(0), rtol=1e-5, atol=1e-5)


def test_rnn_scan_backward_copies_misaligned_views(cuda):
    """y and gh that start off a 16-byte boundary (views 1 element in) are
    copied before K3b runs on them: the same result as aligned copies."""
    y, gh, w, lens = _rnn_backward_inputs(cuda, 9, 5, torch.float32, seed=4)
    by, bg = torch.empty(y.numel() + 1, device=cuda), torch.empty(gh.numel() + 1, device=cuda)
    vy, vg = by[1:].view(y.shape), bg[1:].view(gh.shape)
    vy.copy_(y)
    vg.copy_(gh)
    assert vy.data_ptr() % 16 and vg.data_ptr() % 16
    got = rnn_scan_backward(vy, vg, w, lens)
    want = rnn_scan_backward(y, gh, w, lens)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rnn_scan_autograd_launches_k3b(cuda):
    xproj, w, b, h0, lens = _rnn_inputs(cuda, 9, 6, torch.float32)
    xproj.requires_grad_(True)
    w.requires_grad_(True)
    before = rnn_scan_backward.kernel_launches
    all_h, last = rnn_scan(xproj, w, b, torch.float32, h0=h0, seq_lengths=lens)
    (all_h.square().sum() + last.sum()).backward()
    torch.cuda.synchronize()
    assert rnn_scan_backward.kernel_launches == before + 1
    x2, w2 = xproj.detach().cpu().requires_grad_(True), w.detach().cpu().requires_grad_(True)
    ref_h, ref_last = rnn_scan_reference(x2, w2, b.cpu(), torch.float32, h0=h0.cpu(),
                                         seq_lengths=lens.cpu())
    (ref_h.square().sum() + ref_last.sum()).backward()
    torch.testing.assert_close(xproj.grad.cpu(), x2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(w.grad.cpu(), w2.grad, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- K6 (hot/cold)

def _hotcold_case(cuda, layout, d, B, T, L, k, masked, seed, rows=300, pad=True,
                  bare_bags=False):
    """Tables of ``layout`` (T tables of ``rows`` rows), zipf(1.2) ids, the
    ``k`` most frequent rows as the hot set (k = -1: every row), the split
    (native, padded to the cold ladder unless not ``pad``) on the card;
    ``masked``: a ragged mask, ``bare_bags``: every other bag of table 0
    masked out (no lookup at all); ``(tables, hot, offsets, indices, mask,
    split)``."""
    from deeprecsys_tpu_torch.kernel_bench import random_int8_tables
    from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
    from deeprecsys_tpu_torch.ops.hotcold import select_hot_ids, split_hot_cold

    rng = np.random.default_rng(seed)
    idx = (rng.zipf(1.2, size=(B, T, L)) % rows).astype(np.int32)
    offsets = np.arange(T, dtype=np.int64) * rows
    mask = rng.random((B, T, L)) < 0.6 if masked else None
    if bare_bags:
        mask = np.ones((B, T, L), bool) if mask is None else mask
        mask[::2, 0] = False
    hot_ids = (np.arange(T * rows, dtype=np.int64) if k < 0
               else select_hot_ids(idx, offsets, k))
    split = split_hot_cold(idx, offsets, hot_ids, cold_buckets=cold_buckets_for(B * T * L),
                           impl="native", slot_mask=mask, pad=pad)
    g = torch.Generator(device=cuda).manual_seed(seed)
    if layout in ("int8", "int8_rowwise"):
        shape = types.SimpleNamespace(total_rows=T * rows, num_tables=T, sparse_feature_size=d)
        t = random_int8_tables(shape, g, cuda)
        tables = {"q": t["q"], "scale": t["scale"]} if layout == "int8" else {"qrows": t["qrows"]}
    else:
        tables = torch.randn((T * rows, d), generator=g, device=cuda).to(layout)
    rows_t = tables if not isinstance(tables, dict) else tables.get("q", tables.get("qrows"))
    hot = rows_t.index_select(0, torch.as_tensor(hot_ids, device=cuda))
    dev_split = {k2: torch.from_numpy(np.ascontiguousarray(split[k2])).to(cuda)
                 for k2 in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}
    return (tables, hot, torch.as_tensor(offsets, dtype=torch.int32, device=cuda),
            torch.from_numpy(idx).to(cuda), None if mask is None else torch.from_numpy(mask).to(cuda),
            dev_split)


# K6's cases: (k, masked, pad, bare_bags). A hot set; every row hot; K = 0
# (all cold); no pads (n_cold == C_pad); C_pad == 0 (every row hot, no
# pads); a ragged mask with a hot set, with every row hot (masked-out slots
# the only non-hot ones, none of them cold) and with K = 0 (every valid
# slot cold, fewer cold entries than non-hot slots); bags with no lookup
# (long runs of cold_start).
HOTCOLD_CASES = {"hot set": (40, False, True, False), "all hot": (-1, False, True, False),
                 "K = 0": (0, False, True, False), "no pads": (40, False, False, False),
                 "C_pad == 0": (-1, False, False, False), "ragged": (40, True, True, False),
                 "ragged, all hot": (-1, True, True, False), "ragged, K = 0": (0, True, True, False),
                 "bags with no lookup": (40, True, True, True)}


@pytest.mark.parametrize("case", list(HOTCOLD_CASES))
@pytest.mark.parametrize("B,T,L", [(1, 1, 1), (40, 3, 1), (7, 3, 3), (7, 3, 5), (9, 5, 8),
                                   (11, 3, 9), (5, 3, 40), (33, 5, 80), (3, 2, 120),
                                   (3, 2, 200)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("layout,cdt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), ("int8", torch.bfloat16), ("int8", torch.float32),
    ("int8_rowwise", torch.bfloat16), ("int8_rowwise", torch.float32)])
def test_hotcold_kernel_matches_plain_and_direct(cuda, layout, cdt, d, B, T, L, case):
    """K6 against its plain version and against the direct kernel (K1,
    K1-int8, K4) on the same ids: per-table int8 bit for bit, float and
    row-wise within the order of their f32 sums."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_hotcold, embedding_bag_hotcold_int8, embedding_bag_hotcold_int8_reference,
        embedding_bag_hotcold_int8_rowwise, embedding_bag_hotcold_int8_rowwise_reference,
        embedding_bag_hotcold_reference)
    from deeprecsys_tpu_torch.ops.embedding import hotcold_tolerance

    k, masked, pad, bare = HOTCOLD_CASES[case]
    tables, hot, offsets, idx, mask, split = _hotcold_case(
        cuda, layout, d, B, T, L, k, masked, seed=B * 7 + L, pad=pad, bare_bags=bare)
    if case == "C_pad == 0":
        assert split["cold_ids"].numel() == 0
    if layout == "int8":
        wrapper = embedding_bag_hotcold_int8
        before = wrapper.kernel_launches
        got = wrapper(hot, tables["q"], tables["scale"], split, compute_dtype=cdt)
        torch.cuda.synchronize()
        want = embedding_bag_hotcold_int8_reference(hot, tables["q"], tables["scale"], split,
                                                    compute_dtype=cdt)
        direct = embedding_bag_int8(tables["q"], tables["scale"], offsets, idx,
                                    compute_dtype=cdt, mask=mask)
        assert torch.equal(got, want) and torch.equal(got, direct)
    elif layout == "int8_rowwise":
        wrapper = embedding_bag_hotcold_int8_rowwise
        before = wrapper.kernel_launches
        got = wrapper(hot, tables["qrows"], split, compute_dtype=cdt)
        torch.cuda.synchronize()
        want = embedding_bag_hotcold_int8_rowwise_reference(hot, tables["qrows"], split,
                                                            compute_dtype=cdt)
        tol = hotcold_tolerance(got, want, hot, tables["qrows"], split, rowwise=True)
        assert bool(((got.float() - want.float()).abs() <= tol).all())
        direct = embedding_bag_int8_rowwise(tables["qrows"], offsets, idx, compute_dtype=cdt,
                                            mask=mask)
        tol = rowwise_tolerance(got, direct, tables["qrows"], offsets, idx, mask)
        assert bool(((got.float() - direct.float()).abs() <= tol).all())
    else:
        wrapper = embedding_bag_hotcold
        before = wrapper.kernel_launches
        got = wrapper(hot, tables, split, compute_dtype=cdt)
        torch.cuda.synchronize()
        want = embedding_bag_hotcold_reference(hot, tables, split, compute_dtype=cdt)
        tol = hotcold_tolerance(got, want, hot, tables, split)
        assert bool(((got.float() - want.float()).abs() <= tol).all())
        direct = embedding_bag(tables, offsets, idx, compute_dtype=cdt, mask=mask)
        tol = pooled_tolerance(got, direct, tables, offsets, idx, mask)
        assert bool(((got.float() - direct.float()).abs() <= tol).all())
    assert wrapper.kernel_launches == before + 1
    assert got.dtype == cdt and got.shape == (B, T, d)


@pytest.mark.parametrize("case", ["hot set", "all hot", "K = 0", "no pads", "ragged",
                                  "ragged, all hot", "ragged, K = 0", "bags with no lookup"])
@pytest.mark.parametrize("B,T,L", [(1, 1, 9), (1, 3, 120), (5, 3, 120), (7, 1, 33), (9, 3, 17),
                                   (3, 2, 200), (11, 5, 80)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_hotcold_int8_long_bags_bit_for_bit(cuda, cdt, d, B, T, L, case):
    """K6-int8 on long bags, where its plan pools several bags a warp (4 at
    d = 64): bag counts that are no multiple of 4 (a last task of 1-3
    bags), fewer bags than a task, windows past one (L = 120, 200), ragged
    masks, every row hot, K = 0: bit for bit against its plain version and
    K1-int8 on the same ids."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_hotcold_int8, embedding_bag_hotcold_int8_reference)

    k, masked, pad, bare = HOTCOLD_CASES[case]
    tables, hot, offsets, idx, mask, split = _hotcold_case(
        cuda, "int8", d, B, T, L, k, masked, seed=B * 11 + L + d, pad=pad, bare_bags=bare)
    got = embedding_bag_hotcold_int8(hot, tables["q"], tables["scale"], split, compute_dtype=cdt)
    torch.cuda.synchronize()
    want = embedding_bag_hotcold_int8_reference(hot, tables["q"], tables["scale"], split,
                                                compute_dtype=cdt)
    direct = embedding_bag_int8(tables["q"], tables["scale"], offsets, idx, compute_dtype=cdt,
                                mask=mask)
    assert torch.equal(got, want) and torch.equal(got, direct)


@pytest.mark.parametrize("case", list(HOTCOLD_CASES))
@pytest.mark.parametrize("B,T,L", [(1, 1, 1), (7, 3, 3), (33, 5, 80), (300, 40, 2)])
def test_hotcold_cold_starts_match_searchsorted(cuda, B, T, L, case):
    """K6's first launch alone (``hotcold_cold_starts``) against
    torch.searchsorted of the sorted cold stream, used here only: the lower
    bound of every bag and, last, the first pad; and against its plain
    version."""
    from deeprecsys_tpu_torch.ops.embedding import (
        hotcold_cold_starts, hotcold_cold_starts_reference)

    k, masked, pad, bare = HOTCOLD_CASES[case]
    *_, split = _hotcold_case(cuda, torch.bfloat16, 32, B, T, L, k, masked, seed=B + L,
                              pad=pad, bare_bags=bare)
    seg = split["cold_seg"]
    got = hotcold_cold_starts(seg, B * T)
    torch.cuda.synchronize()
    want = torch.searchsorted(seg, torch.arange(B * T + 1, dtype=torch.int32, device=cuda))
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    assert torch.equal(got, hotcold_cold_starts_reference(seg, B * T))
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    assert torch.equal(hotcold_cold_starts(empty, B * T),
                       torch.zeros(B * T + 1, dtype=torch.int32, device=cuda))


def test_hotcold_kernel_rejects_misaligned_tables(cuda):
    from deeprecsys_tpu_torch.ops import embedding_bag_hotcold, embedding_bag_hotcold_int8_rowwise

    tables, hot, _, _, _, split = _hotcold_case(cuda, torch.bfloat16, 32, 4, 2, 3, 10, False, 1)
    base = torch.zeros((tables.numel() + 4,), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        embedding_bag_hotcold(hot, base[4:].view(tables.shape), split)
    tables, hot, _, _, _, split = _hotcold_case(cuda, "int8_rowwise", 32, 4, 2, 3, 10, False, 1)
    base = torch.zeros((tables["qrows"].numel() + 2,), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="4-byte"):
        embedding_bag_hotcold_int8_rowwise(hot, base[2:].view(tables["qrows"].shape), split)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("B,L", [(37, 23), (7, 3), (5, 1), (16, 80)])
def test_window_kernels_match_plain_and_combine_to_the_direct_kernels(cuda, B, L, d, masked):
    """K1, K1-int8 and K4 with the ownership window, on each of 4 row
    shards: each partial against its plain version (``window=``), the
    four summed (and scaled, cast) against the direct kernel."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_int8_rowwise_shard, embedding_bag_int8_shard, embedding_bag_shard)

    rows = (500, 300, 700, 100)  # 1600 rows: shards of 400 cut tables
    q, scale, qrows, offsets, indices, mask = _int8_inputs(cuda, rows, d, B, L, d + B, masked)
    g = torch.Generator(device=cuda).manual_seed(L)
    table = torch.randn((sum(rows), d), generator=g, device=cuda).to(torch.bfloat16)
    rps = sum(rows) // 4
    parts = {"k1": [], "k1_int8": [], "k4": []}
    for m in range(4):
        lo, w = m * rps, (m * rps, (m + 1) * rps)
        got = embedding_bag_shard(table[lo:lo + rps], offsets, indices, lo, mask=mask)
        want = embedding_bag_reference(table[lo:lo + rps], offsets, indices, mask=mask, window=w)
        assert got.dtype == torch.float32
        tol = pooled_tolerance(got, want, table[lo:lo + rps], offsets, indices, mask, window=w)
        assert bool(((got - want).abs() <= tol).all())
        parts["k1"].append(got)
        got = embedding_bag_int8_shard(q[lo:lo + rps], offsets, indices, lo, mask=mask)
        want = embedding_bag_int8_reference(q[lo:lo + rps], None, offsets, indices, mask=mask,
                                            window=w)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        parts["k1_int8"].append(got)
        got = embedding_bag_int8_rowwise_shard(qrows[lo:lo + rps], offsets, indices, lo,
                                               mask=mask)
        want = embedding_bag_int8_rowwise_reference(qrows[lo:lo + rps], offsets, indices,
                                                    mask=mask, window=w)
        tol = rowwise_tolerance(got, want, qrows[lo:lo + rps], offsets, indices, mask, window=w)
        assert bool(((got - want).abs() <= tol).all())
        parts["k4"].append(got)
    direct = embedding_bag(table, offsets, indices, mask=mask)
    combined = sum(parts["k1"]).to(torch.bfloat16)
    assert bool(((combined.float() - direct.float()).abs()
                 <= pooled_tolerance(combined, direct, table, offsets, indices, mask)).all())
    full = embedding_bag_shard(table, offsets, indices, 0, mask=mask)
    assert torch.equal(full.to(torch.bfloat16), direct)
    i8 = sum(parts["k1_int8"])
    assert torch.equal((i8.float() * scale[None, :, None]).to(torch.bfloat16),
                       embedding_bag_int8(q, scale, offsets, indices,
                                          compute_dtype=torch.bfloat16, mask=mask))
    k4 = embedding_bag_int8_rowwise(qrows, offsets, indices, mask=mask)
    assert bool(((sum(parts["k4"]) - k4).abs()
                 <= rowwise_tolerance(sum(parts["k4"]), k4, qrows, offsets, indices, mask)).all())


@pytest.mark.parametrize("layout", ["none", "int8", "int8_rowwise"])
@pytest.mark.parametrize("B,T,L", [(7, 3, 3), (33, 5, 80), (300, 4, 1)])
def test_hotcold_shard_kernels_match_plain_and_combine(cuda, layout, B, T, L):
    """K6 on each of 4 row shards' cold streams (the mesh splitter's
    shard-local ids), the hot hits on shard 0 only: each partial against
    its plain version (int32 for per-table int8, bit for bit), the four
    combined against the direct kernel on the same ids."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_hotcold_int8_reference, embedding_bag_hotcold_int8_rowwise_reference,
        embedding_bag_hotcold_int8_rowwise_shard, embedding_bag_hotcold_int8_shard,
        embedding_bag_hotcold_reference, embedding_bag_hotcold_shard)
    from deeprecsys_tpu_torch.ops.embedding import hotcold_tolerance
    from deeprecsys_tpu_torch.ops.hotcold import select_hot_ids, split_hot_cold_sharded

    rng = np.random.default_rng(B + L)
    rows = 300
    R = rows * T
    offsets = torch.arange(T, dtype=torch.int32, device=cuda) * rows
    idx = (rng.zipf(1.3, size=(B, T, L)) % rows).astype(np.int32)
    off64 = np.arange(T, dtype=np.int64) * rows
    hot_ids = select_hot_ids(idx, off64, 40)
    g = torch.Generator(device=cuda).manual_seed(T)
    if layout == "none":
        table = torch.randn((R, 32), generator=g, device=cuda).to(torch.bfloat16)
    else:
        table = torch.randint(-127, 128, (R, 32), generator=g, device=cuda, dtype=torch.int8)
        if layout == "int8_rowwise":
            table = torch.cat([table, (torch.rand((R,), generator=g, device=cuda) * 1e-2 + 1e-4)
                               .view(torch.int8).reshape(R, 4)], dim=1)
    rps = R // 4
    split = split_hot_cold_sharded(idx, off64, hot_ids, 4, rps)
    hot = table.index_select(0, torch.as_tensor(hot_ids, device=cuda))
    parts = []
    for m in range(4):
        s = {"hot_sel": torch.from_numpy(split["hot_sel"]).to(cuda),
             "hot_mask": torch.from_numpy(split["hot_mask"] & (m == 0)).to(cuda),
             "cold_ids": torch.from_numpy(split["cold_local"][m]).to(cuda),
             "cold_seg": torch.from_numpy(split["cold_seg"][m]).to(cuda)}
        shard = table[m * rps:(m + 1) * rps]
        if layout == "int8":
            got = embedding_bag_hotcold_int8_shard(hot, shard, s)
            want = embedding_bag_hotcold_int8_reference(hot, shard, None, s, partial=True)
            assert got.dtype == torch.int32 and torch.equal(got, want)
        else:
            rowwise = layout == "int8_rowwise"
            fn = embedding_bag_hotcold_int8_rowwise_shard if rowwise else \
                embedding_bag_hotcold_shard
            ref = (embedding_bag_hotcold_int8_rowwise_reference if rowwise
                   else embedding_bag_hotcold_reference)
            got, want = fn(hot, shard, s), ref(hot, shard, s, partial=True)
            assert got.dtype == torch.float32
            assert bool(((got - want).abs()
                         <= hotcold_tolerance(got, want, hot, shard, s, rowwise=rowwise)).all())
        parts.append(got)
    acc = sum(parts)
    ids = torch.from_numpy(idx).to(cuda)
    if layout == "int8":
        scale = torch.rand((T,), generator=g, device=cuda) * 1e-2 + 1e-4
        assert torch.equal(acc.float() * scale[None, :, None],
                           embedding_bag_int8(table, scale, offsets, ids))
    elif layout == "int8_rowwise":
        want = embedding_bag_int8_rowwise(table, offsets, ids)
        assert bool(((acc - want).abs()
                     <= rowwise_tolerance(acc, want, table, offsets, ids)).all())
    else:
        got, want = acc.to(torch.bfloat16), embedding_bag(table, offsets, ids)
        assert bool(((got.float() - want.float()).abs()
                     <= pooled_tolerance(got, want, table, offsets, ids)).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 32, 64, 100])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("B,T,L,rows", [(37, 3, 23, 52), (128, 8, 80, 2000), (5, 2, 1, 4)])
def test_backward_window_matches_plain(cuda, B, T, L, rows, shards, d, g_dt, masked):
    """K1b's window on each row shard (the shards cut through the tables)
    against its plain version; the shards together against the direct K1b."""
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_shard

    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=L + d + shards)
    grad = grad.to(g_dt)
    mask = (torch.rand((B, T, L), generator=gen, device=cuda) < 0.7) if masked else None
    R = T * rows
    rps = R // shards
    parts = []
    for m in range(shards):
        w = (m * rps, (m + 1) * rps)
        before = embedding_bag_backward_shard.kernel_launches
        got = embedding_bag_backward_shard(grad, offsets, indices, w[0], rps, mask=mask)
        torch.cuda.synchronize()
        assert embedding_bag_backward_shard.kernel_launches == before + 1
        want = embedding_bag_backward_reference(grad, offsets, indices, rps, mask=mask, window=w)
        tol = backward_tolerance(grad, offsets, indices, rps, mask, window=w)
        assert got.dtype == torch.float32 and got.shape == (rps, d)
        assert bool(((got - want).abs() <= tol).all())
        parts.append(got)
    direct = embedding_bag_backward(grad, offsets, indices, R, mask=mask)
    tol = backward_tolerance(grad, offsets, indices, R, mask)
    assert bool(((torch.cat(parts) - direct).abs() <= 2 * tol).all())


def test_shard_autograd_launches_the_backward_window(cuda):
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_shard, embedding_bag_shard

    gen, offsets, indices, _ = _dup_inputs(cuda, 16, 3, 7, 40, 32, seed=4)
    table = torch.randn((120, 32), generator=gen, device=cuda)
    shards = [table[m * 30:(m + 1) * 30].clone().requires_grad_(True) for m in range(4)]
    before = embedding_bag_backward_shard.kernel_launches
    out = sum(embedding_bag_shard(t, offsets, indices, 30 * m) for m, t in enumerate(shards))
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert embedding_bag_backward_shard.kernel_launches == before + 4
    want = embedding_bag_backward_reference(2 * out.detach(), offsets, indices, 120)
    torch.testing.assert_close(torch.cat([t.grad for t in shards]), want, rtol=1e-5, atol=1e-5)


# Windows over the tables (3000, 500, 2000, 700) rows, fused 6200: K1b's
# and K4's windows launch over the meeting tables alone (TableRange).
WINDOW_ROWS = (3000, 500, 2000, 700)
WINDOW_CASES = {
    "aligned": (3000, 500),          # table 1 exactly
    "straddling": (2500, 3300),      # tables 0-2, the first and last straddling
    "one table": (1000, 1000),       # inside table 0
    "last table": (5500, 700),       # the last table, to the fused table's end
}


@pytest.mark.parametrize("L", [23, 5, 1])
@pytest.mark.parametrize("d", [8, 32, 64])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_table_range_windows_match_plain(cuda, case, d, L):
    """K1b's window (f32 and bf16 gradients) and K4's window on an aligned,
    a straddling, a one-table and a last-table window, with the range the
    placement makes (``table_range`` with the fused rows) and the one the
    wrapper derives, masked: each within its tolerance of the plain version
    (the bags of the other tables exactly 0 in K4's partial, written over
    memory that held NaN)."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_backward_shard, embedding_bag_int8_rowwise_shard)
    from deeprecsys_tpu_torch.ops.embedding import table_range

    row_lo, rows = WINDOW_CASES[case]
    w = (row_lo, row_lo + rows)
    _, _, qrows, offsets, indices, mask = _int8_inputs(cuda, WINDOW_ROWS, d, 37, L,
                                                       seed=d + L + rows, masked=True)
    R, B, T = sum(WINDOW_ROWS), 37, len(WINDOW_ROWS)
    placed = table_range(np.cumsum((0,) + WINDOW_ROWS[:-1]), row_lo, rows, R)
    shard = qrows[row_lo:row_lo + rows]
    for tr in (placed, None):
        junk = torch.full((B, T, d), float("nan"), device=cuda)
        del junk  # the partial's memory held NaN: the launch must write every bag
        before = embedding_bag_int8_rowwise_shard.kernel_launches
        got = embedding_bag_int8_rowwise_shard(shard, offsets, indices, row_lo, mask=mask,
                                               table_range=tr)
        torch.cuda.synchronize()
        assert embedding_bag_int8_rowwise_shard.kernel_launches == before + 1
        want = embedding_bag_int8_rowwise_reference(shard, offsets, indices, mask=mask, window=w)
        tol = rowwise_tolerance(got, want, shard, offsets, indices, mask, window=w)
        assert bool(((got - want).abs() <= tol).all()), (case, tr)
        foreign = [t for t in range(T) if not placed.lo <= t < placed.hi]
        assert bool((got[:, foreign] == 0).all())
        g = torch.randn((B, T, d), generator=torch.Generator(device=cuda).manual_seed(L),
                        device=cuda)
        for g_dt in (torch.float32, torch.bfloat16):
            gg = g.to(g_dt)
            got = embedding_bag_backward_shard(gg, offsets, indices, row_lo, rows, mask=mask,
                                               table_range=tr)
            torch.cuda.synchronize()
            want = embedding_bag_backward_reference(gg, offsets, indices, rows, mask=mask,
                                                    window=w)
            tol = backward_tolerance(gg, offsets, indices, rows, mask, window=w)
            assert bool(((got - want).abs() <= tol).all()), (case, tr, g_dt)


@pytest.mark.parametrize("L", [23, 5, 1])
@pytest.mark.parametrize("d", [8, 32, 64])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_k1_int8_table_range_windows_match_plain(cuda, case, d, L):
    """K1-int8's window over the meeting tables on an aligned, a
    straddling, a one-table and a last-table window, with the range the
    placement makes and the one the wrapper derives, masked and not: the
    int32 pool bit for bit its plain version, the other tables' bags 0
    (written over memory that held NaN), one launch a call."""
    from deeprecsys_tpu_torch.ops import embedding_bag_int8_shard
    from deeprecsys_tpu_torch.ops.embedding import table_range

    row_lo, rows = WINDOW_CASES[case]
    w = (row_lo, row_lo + rows)
    q, _, _, offsets, indices, mask = _int8_inputs(cuda, WINDOW_ROWS, d, 37, L,
                                                   seed=2 * d + L + rows, masked=True)
    B, T = 37, len(WINDOW_ROWS)
    placed = table_range(np.cumsum((0,) + WINDOW_ROWS[:-1]), row_lo, rows, sum(WINDOW_ROWS))
    shard = q[row_lo:row_lo + rows]
    foreign = [t for t in range(T) if not placed.lo <= t < placed.hi]
    for tr in (placed, None):
        for m_ in (mask, None):
            junk = torch.full((B, T, d), float("nan"), device=cuda)
            del junk  # the partial's memory held NaN: the launch must write every bag
            before = embedding_bag_int8_shard.kernel_launches
            got = embedding_bag_int8_shard(shard, offsets, indices, row_lo, mask=m_,
                                           table_range=tr)
            torch.cuda.synchronize()
            assert embedding_bag_int8_shard.kernel_launches == before + 1
            want = embedding_bag_int8_reference(shard, None, offsets, indices, mask=m_, window=w)
            assert got.dtype == torch.int32 and torch.equal(got, want), (case, tr)
            assert bool((got[:, foreign] == 0).all())


def test_table_range_windows_skip_when_no_table_meets(cuda):
    """An empty shard: K1b's window launches nothing (no table meets it)
    and K1-int8's and K4's write partials of zeros."""
    from deeprecsys_tpu_torch.ops import (
        embedding_bag_backward_shard, embedding_bag_int8_rowwise_shard, embedding_bag_int8_shard)

    q, _, qrows, offsets, indices, _ = _int8_inputs(cuda, WINDOW_ROWS, 32, 9, 7, seed=3,
                                                    masked=False)
    before = embedding_bag_backward_shard.kernel_launches
    g = torch.randn((9, len(WINDOW_ROWS), 32), device=cuda)
    got = embedding_bag_backward_shard(g, offsets, indices, 100, 0)
    assert got.shape == (0, 32) and embedding_bag_backward_shard.kernel_launches == before
    got = embedding_bag_int8_rowwise_shard(qrows[100:100], offsets, indices, 100)
    torch.cuda.synchronize()
    assert bool((got == 0).all())
    got = embedding_bag_int8_shard(q[100:100], offsets, indices, 100)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and bool((got == 0).all())


def test_k1_int8_window_refuses_a_range_that_does_not_fit(cuda):
    from deeprecsys_tpu_torch.ops import embedding_bag_int8_shard
    from deeprecsys_tpu_torch.ops.embedding import TableRange

    q, _, _, offsets, indices, _ = _int8_inputs(cuda, WINDOW_ROWS, 32, 9, 7, seed=3,
                                                masked=False)
    with pytest.raises(ValueError, match="does not fit"):
        embedding_bag_int8_shard(q[:500], offsets, indices, 0,
                                 table_range=TableRange(3, 5, False, True))


# K6 on shard 0 (the hits; cold_starts_kernel, then the pool):
# (ids, k, masked). zipf and uniform ids with a hot set; K = 0 (every
# valid slot cold); every row hot (shard 0's stream all pads); a ragged
# mask; and a stream with no pads (the whole table as one shard, its cold
# stream unpadded: a bag's entries may end at C_pad).
SHARD0_CASES = {"zipf": ("zipf", 40, False), "uniform": ("uniform", 40, False),
                "K = 0": ("zipf", 0, False), "empty cold stream": ("zipf", -1, False),
                "ragged": ("zipf", 40, True), "no pads": ("zipf", 40, True)}


@pytest.mark.parametrize("case", list(SHARD0_CASES))
@pytest.mark.parametrize("d", [32, 64, 8])
@pytest.mark.parametrize("B,T,L", [(9, 3, 80), (33, 5, 17), (40, 4, 3)])
@pytest.mark.parametrize("layout", ["none", "int8", "int8_rowwise"])
def test_hotcold_shard0_matches_plain(cuda, layout, B, T, L, d, case):
    """K6 on shard 0 of a 1x4 split (``split_hot_cold_sharded``: the hits
    and shard 0's cold stream) against ``embedding_bag_hotcold*_reference(
    ..., partial=True)``: per-table int8 bit for bit, float and row-wise
    within ``hotcold_tolerance``; d 8 takes the general instance, L 3 the
    short-bag mapping, int8 at d 64 four bags a warp. The call (both
    launches) is counted once."""
    from deeprecsys_tpu_torch.ops import embedding as emb
    from deeprecsys_tpu_torch.ops.hotcold import (
        select_hot_ids, split_hot_cold, split_hot_cold_sharded)

    ids, k, masked = SHARD0_CASES[case]
    rows = 200
    R = rows * T
    rng = np.random.default_rng(B + L + d)
    idx = ((rng.zipf(1.2, size=(B, T, L)) if ids == "zipf"
            else rng.integers(0, rows, size=(B, T, L))) % rows).astype(np.int32)
    off64 = np.arange(T, dtype=np.int64) * rows
    mask = rng.random((B, T, L)) < 0.6 if masked else None
    hot_ids = (np.arange(R, dtype=np.int64) if k < 0
               else select_hot_ids(idx, off64, k) if k else np.empty(0, np.int64))
    if case == "no pads":
        rps = R
        sp = split_hot_cold(idx, off64, hot_ids, pad=False, slot_mask=mask)
        cold_ids, cold_seg = sp["cold_ids"], sp["cold_seg"]
        assert cold_seg.size and (cold_seg < B * T).all()
    else:
        rps = R // 4
        sp = split_hot_cold_sharded(idx, off64, hot_ids, 4, rps, slot_mask=mask)
        cold_ids, cold_seg = sp["cold_local"][0], sp["cold_seg"][0]
    g = torch.Generator(device=cuda).manual_seed(d)
    if layout == "none":
        table = torch.randn((R, d), generator=g, device=cuda).to(torch.bfloat16)
    else:
        table = torch.randint(-127, 128, (R, d), generator=g, device=cuda, dtype=torch.int8)
        if layout == "int8_rowwise":
            table = torch.cat([table, (torch.rand((R,), generator=g, device=cuda) * 1e-2 + 1e-4)
                               .view(torch.int8).reshape(R, 4)], dim=1)
    hot = table.index_select(0, torch.as_tensor(hot_ids, device=cuda))
    s = {"hot_sel": torch.from_numpy(sp["hot_sel"]).to(cuda),
         "hot_mask": torch.from_numpy(sp["hot_mask"]).to(cuda),
         "cold_ids": torch.from_numpy(np.ascontiguousarray(cold_ids)).to(cuda),
         "cold_seg": torch.from_numpy(np.ascontiguousarray(cold_seg)).to(cuda)}
    fn = {"none": emb.embedding_bag_hotcold_shard, "int8": emb.embedding_bag_hotcold_int8_shard,
          "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[layout]
    before = fn.kernel_launches
    got = fn(hot, table[:rps], s)
    torch.cuda.synchronize()
    assert fn.kernel_launches == before + 1
    if layout == "int8":
        want = emb.embedding_bag_hotcold_int8_reference(hot, table[:rps], None, s, partial=True)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        rowwise = layout == "int8_rowwise"
        want = (emb.embedding_bag_hotcold_int8_rowwise_reference if rowwise
                else emb.embedding_bag_hotcold_reference)(hot, table[:rps], s, partial=True)
        tol = emb.hotcold_tolerance(got, want, hot, table[:rps], s, rowwise=rowwise)
        assert got.dtype == torch.float32 and bool(((got - want).abs() <= tol).all())
    if case == "empty cold stream":
        assert not bool((s["cold_seg"] < B * T).any())


def test_backward_window_rejects_a_misaligned_out(cuda):
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_shard

    _, offsets, indices, g = _dup_inputs(cuda, 4, 2, 3, 10, 32, seed=1)
    base = torch.zeros((10 * 32 + 1,), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        embedding_bag_backward_shard(g, offsets, indices, 0, 10, out=base[1:].view(10, 32))


@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 32, 64, 100])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("B,T,L,rows", [(37, 3, 23, 52), (128, 8, 80, 2000), (129, 43, 1, 500)])
def test_sparse_adagrad_window_matches_plain(cuda, B, T, L, rows, shards, d, table_dt, g_dt):

    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=B + L + shards)
    grad = (grad * 1e-2).to(g_dt)
    R = T * rows
    rps = R // shards
    table0 = (torch.rand((R, d), generator=gen, device=cuda) - 0.5).to(table_dt)
    acc0 = torch.rand((R,), generator=gen, device=cuda) * 1e-4
    for m in range(shards):
        w = (m * rps, (m + 1) * rps)
        t0, a0 = table0[w[0]:w[1]], acc0[w[0]:w[1]]
        table, acc = t0.clone(), a0.clone()
        before = sparse_adagrad_step_shard.kernel_launches
        sparse_adagrad_step_shard(table, acc, offsets, indices, grad, w[0], 0.1)
        torch.cuda.synchronize()
        assert sparse_adagrad_step_shard.kernel_launches == before + 1
        want_t, want_a = t0.clone(), a0.clone()
        sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1, window=w)
        tol, acc_tol = sparse_adagrad_tolerance(t0, a0, offsets, indices, grad, 0.1, window=w)
        assert bool(((acc - want_a).abs() <= acc_tol).all())
        assert bool(((table.float() - want_t.float()).abs() <= tol).all())


def _cold_only_case(cuda, layout, d, case):
    """A 4-shard split of a small table (T 3 x 300 rows) and the table in
    ``layout``: zipf ids with a 40-row hot set; every id hot (each shard's
    stream all pads); or bags of 150 slots whose table-0 ids all lie in
    shard 1 (cold bags of 150 entries, across five of the kernel's chunks
    and past the 64 ids a warp holds), no hot set."""
    from deeprecsys_tpu_torch.ops.hotcold import select_hot_ids, split_hot_cold_sharded

    T, rows = 3, 300
    R, rps = T * rows, T * rows // 4
    rng = np.random.default_rng(d + len(case))
    B, L = (8, 150) if case == "long_bag" else (64, 20)
    idx = (rng.zipf(1.3, size=(B, T, L)) % rows).astype(np.int32)
    off64 = np.arange(T, dtype=np.int64) * rows
    if case == "long_bag":
        idx[:, 0, :] = rng.integers(rps, rows, size=(B, L))  # fused rows of shard 1
        hot_ids = np.empty(0, np.int64)
    else:
        hot_ids = select_hot_ids(idx, off64, R if case == "all_pads" else 40)
    g = torch.Generator(device=cuda).manual_seed(d)
    if layout == "none":
        table = torch.randn((R, d), generator=g, device=cuda).to(torch.bfloat16)
    else:
        table = torch.randint(-127, 128, (R, d), generator=g, device=cuda, dtype=torch.int8)
        if layout == "int8_rowwise":
            table = torch.cat([table, (torch.rand((R,), generator=g, device=cuda) * 1e-2 + 1e-4)
                               .view(torch.int8).reshape(R, 4)], dim=1)
    return table, idx, off64, hot_ids, split_hot_cold_sharded(idx, off64, hot_ids, 4, rps), rps


@pytest.mark.parametrize("case", ["zipf", "all_pads", "long_bag"])
@pytest.mark.parametrize("d", [32, 64, 8])
@pytest.mark.parametrize("layout", ["none", "int8", "int8_rowwise"])
def test_cold_only_shard_kernel_matches_plain_and_combines(cuda, layout, d, case):
    """K6's cold-only route (``hot_table=None``, one launch) on shards 1-3
    against its plain version (int32 bit for bit, else within
    ``cold_tolerance``), counted in the shard wrapper's launches; shard 0's
    K6 with the hits and the three combined against the direct kernel (K1-
    int8 bit for bit)."""
    from deeprecsys_tpu_torch.ops import embedding as emb

    table, idx, off64, hot_ids, split, rps = _cold_only_case(cuda, layout, d, case)
    fn = {"none": emb.embedding_bag_hotcold_shard, "int8": emb.embedding_bag_hotcold_int8_shard,
          "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[layout]
    mode = {"none": "float", "int8": "int8", "int8_rowwise": "int8_rowwise"}[layout]
    B, T, _ = idx.shape
    hot = table.index_select(0, torch.as_tensor(hot_ids, device=cuda))
    parts = []
    for m in range(4):
        shard = table[m * rps:(m + 1) * rps]
        cold = {"cold_ids": torch.from_numpy(split["cold_local"][m]).to(cuda),
                "cold_seg": torch.from_numpy(split["cold_seg"][m]).to(cuda)}
        if m == 0:
            s = dict(cold, hot_sel=torch.from_numpy(split["hot_sel"]).to(cuda),
                     hot_mask=torch.from_numpy(split["hot_mask"]).to(cuda))
            parts.append(fn(hot, shard, s))
            continue
        s = dict(cold, bags=(B, T))
        before = fn.kernel_launches
        got = fn(None, shard, s)
        torch.cuda.synchronize()
        assert fn.kernel_launches == before + 1
        want = emb.embedding_bag_cold_partial_reference(shard, s, mode=mode)
        if layout == "int8":
            assert got.dtype == torch.int32 and torch.equal(got, want)
        else:
            tol = emb.cold_tolerance(got, want, shard, s, rowwise=layout == "int8_rowwise")
            assert got.dtype == torch.float32 and bool(((got - want).abs() <= tol).all())
        if case == "all_pads":
            assert not bool(got.any())
        parts.append(got)
    acc = sum(parts)
    offsets = torch.as_tensor(off64.astype(np.int32), device=cuda)
    ids = torch.from_numpy(idx).to(cuda)
    if layout == "int8":
        scale = torch.rand((T,), device=cuda) * 1e-2 + 1e-4
        assert torch.equal(acc.float() * scale[None, :, None],
                           embedding_bag_int8(table, scale, offsets, ids))
    elif layout == "int8_rowwise":
        want = embedding_bag_int8_rowwise(table, offsets, ids)
        assert bool(((acc - want).abs() <= rowwise_tolerance(acc, want, table, offsets, ids)).all())
    else:
        got, want = acc.to(torch.bfloat16), embedding_bag(table, offsets, ids)
        assert bool(((got.float() - want.float()).abs()
                     <= pooled_tolerance(got, want, table, offsets, ids)).all())


@pytest.mark.parametrize("layout", ["none", "int8", "int8_rowwise"])
def test_cold_only_kernel_on_an_empty_stream_writes_zeros(cuda, layout):
    from deeprecsys_tpu_torch.ops import embedding as emb

    table, _, _, _, _, rps = _cold_only_case(cuda, layout, 32, "zipf")
    fn = {"none": emb.embedding_bag_hotcold_shard, "int8": emb.embedding_bag_hotcold_int8_shard,
          "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[layout]
    empty = torch.empty((0,), dtype=torch.int32, device=cuda)
    got = fn(None, table[rps:2 * rps], {"cold_ids": empty, "cold_seg": empty, "bags": (70, 3)})
    assert got.shape == (70, 3, 32) and not bool(got.any())


@pytest.mark.parametrize("table_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["batch", "repeated", "owns_nothing"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sparse_adagrad_window_plans_match_plain_twice(cuda, shards, case, table_dt):
    """K5's window, each call twice in a row on one stream: a bf16 shard's
    kept scratch (the count the next call takes, the hash keys) is left
    zero and free, so the second call is as right as the first.
    Cases: the batch's ids, ids on 7 rows a table (rows of ~150 adds), and
    a shard past every id (it owns nothing)."""
    from deeprecsys_tpu_torch.ops import sparse_adagrad as sa

    B, T, L, rows, d = 64, 3, 80, 300, 32
    gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=shards + len(case))
    if case == "repeated":
        indices = indices % 7
    grad = grad * 1e-2
    R = T * rows
    rps = R // shards
    table0 = (torch.rand((R + rps, d), generator=gen, device=cuda) - 0.5).to(table_dt)
    acc0 = torch.rand((R + rps,), generator=gen, device=cuda) * 1e-4
    windows = ([(R, R + rps)] if case == "owns_nothing"
               else [(m * rps, (m + 1) * rps) for m in range(shards)])
    for w in windows:
        t0, a0 = table0[w[0]:w[1]], acc0[w[0]:w[1]]
        table, acc = t0.clone(), a0.clone()
        want_t, want_a = t0.clone(), a0.clone()
        for _ in range(2):
            t1, a1 = table.clone(), acc.clone()
            sparse_adagrad_step_shard(table, acc, offsets, indices, grad, w[0], 0.1)
            torch.cuda.synchronize()
            sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1,
                                          window=w)
            tol, acc_tol = sparse_adagrad_tolerance(t1, a1, offsets, indices, grad, 0.1,
                                                    window=w)
            assert bool(((acc - want_a).abs() <= acc_tol).all()), w
            assert bool(((table.float() - want_t.float()).abs() <= tol).all()), w
            table.copy_(want_t)  # each step held from the plain version's state
            acc.copy_(want_a)
    if table_dt == torch.bfloat16:
        state = sa._WINDOW_STATE[(torch.cuda.current_device(),
                                  torch.cuda.current_stream().cuda_stream)]
        assert int(state["count"][state["calls"] % 2]) == 0  # the next call's count
        assert bool((state["keys"] == -1).all())


@pytest.mark.parametrize("table_dt", [torch.float32, torch.bfloat16])
def test_sparse_adagrad_window_after_a_larger_stream(cuda, table_dt):
    """K5's window on a stream of 120-slot bags, then on a smaller one on
    the same stream: the scratch kept from the larger call (a longer list,
    more hash keys) serves the smaller one, which is as right as on fresh
    scratch."""
    from deeprecsys_tpu_torch.ops import sparse_adagrad as sa

    d, rows, T = 32, 400, 4
    R = T * rows
    for B, L in ((64, 120), (16, 20), (8, 80)):
        gen, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=B + L)
        grad = grad * 1e-2
        lo, hi = R // 4, R // 2
        table = ((torch.rand((hi - lo, d), generator=gen, device=cuda) - 0.5)).to(table_dt)
        acc = torch.rand((hi - lo,), generator=gen, device=cuda) * 1e-4
        want_t, want_a = table.clone(), acc.clone()
        tol, acc_tol = sparse_adagrad_tolerance(table, acc, offsets, indices, grad, 0.1,
                                                window=(lo, hi))
        sparse_adagrad_step_shard(table, acc, offsets, indices, grad, lo, 0.1)
        sparse_adagrad_step_reference(want_t, want_a, offsets, indices, grad, 0.1,
                                      window=(lo, hi))
        assert bool(((acc - want_a).abs() <= acc_tol).all()), (B, L)
        assert bool(((table.float() - want_t.float()).abs() <= tol).all()), (B, L)


def test_sparse_adagrad_window_refuses_a_graph_capture(cuda):
    """K5's window on a bf16 shard keeps its count and hash keys from call
    to call on the stream, so a CUDA graph (which would replay one call's)
    cannot capture it: the wrapper raises before it launches anything."""
    B, T, L, rows, d = 8, 2, 10, 50, 32
    _, offsets, indices, grad = _dup_inputs(cuda, B, T, L, rows, d, seed=3)
    table = torch.zeros((rows, d), dtype=torch.bfloat16, device=cuda)
    acc = torch.zeros((rows,), device=cuda)
    before = sparse_adagrad_step_shard.kernel_launches
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        with pytest.raises(RuntimeError, match="not capturable"):
            with torch.cuda.graph(graph, stream=stream):
                sparse_adagrad_step_shard(table, acc, offsets, indices, grad, 0, 0.1)
    assert sparse_adagrad_step_shard.kernel_launches == before
