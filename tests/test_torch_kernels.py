"""K1, K3 and the training kernels K1b, K5 and K3b against their plain
versions on a CUDA card.

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
- K1b (``ops.embedding.backward_tolerance``) and K5
  (``ops.sparse_adagrad.sparse_adagrad_tolerance``): the kernels add each
  row's terms with atomics in no fixed order, so a row of n adds agrees
  within n roundings of its running sum (bf16 tables: of the bf16 adds).
- K3b: the reverse scan in f32 against its plain loop, each with its own
  order of the 64-term dot, carried over T steps: within 1e-5 of the
  largest |delta| (``RNN_BACKWARD_RTOL``; chip_smoke.py measures it).
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch.ops import (
    embedding_bag, embedding_bag_backward, embedding_bag_backward_reference,
    embedding_bag_reference, rnn_scan, rnn_scan_backward, rnn_scan_backward_reference,
    rnn_scan_reference, sparse_adagrad_step, sparse_adagrad_step_reference)
from deeprecsys_tpu_torch.ops.embedding import backward_tolerance, pooled_tolerance
from deeprecsys_tpu_torch.ops.rnn import rnn_scan_tolerance
from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_tolerance

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
@pytest.mark.parametrize("d", [32, 64])
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
