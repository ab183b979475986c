"""K1 and K3 against their plain versions on a CUDA card.

These tests need a card; without one they skip. The file imports no JAX,
so it runs where only torch is installed (``--noconftest`` skips
``tests/conftest.py``, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Tolerances:
- K1 (``ops.embedding.pooled_tolerance``): both versions convert rows to
  the compute dtype and sum in f32, so they differ only in summation
  order: |a - b| <= L * 2^-23 * sum|rows|, plus 1 bf16 ulp of the larger
  value for bf16 outputs.
- K3: each step, recomputed from the kernel's own previous state, within
  ``ops.rnn.rnn_scan_tolerance`` (the f32 slack of the dot, tanh's error,
  one ulp of the output dtype; frozen rows exact); the free-running scans
  within 1e-5 (f32) and 2^-7 (bf16) of the plain loop (chip_smoke.py
  states why).
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch.ops import (
    embedding_bag, embedding_bag_reference, rnn_scan, rnn_scan_reference)
from deeprecsys_tpu_torch.ops.embedding import pooled_tolerance
from deeprecsys_tpu_torch.ops.rnn import rnn_scan_tolerance

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
    with pytest.raises(ValueError, match="hidden size 64"):
        rnn_scan(torch.zeros((3, 2, 32), device=cuda), torch.zeros((32, 32), device=cuda),
                 torch.zeros(32, device=cuda), torch.float32)


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
