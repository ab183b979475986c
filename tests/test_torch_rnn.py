"""The port's DIEN RNN (``ops/rnn.py``) against the JAX package's, on the CPU.

The same numpy inputs go through JAX ``basic_rnn_scan`` and the port's,
whose wrapper takes the plain loop for CPU tensors. Tolerances: f32 rtol
and atol 1e-5 (two f32 summation orders drift apart by ~1e-6 over 40
steps); bf16 2 bf16 ulps of values below 1 (2^-7): an f32 dot that lands
near a bf16 rounding boundary may round the other way in one of the two,
and the hidden state then differs by one ulp (2^-8 for |h| in [0.5, 1)),
which the later steps carry but, in these runs, do not grow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu.ops import basic_rnn_scan as jax_basic_rnn_scan
from deeprecsys_tpu_torch.ops import (
    basic_rnn_init, basic_rnn_scan, rnn_scan, rnn_scan_reference)
from deeprecsys_tpu_torch.ops.rnn import rnn_scan_tolerance

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
T, B, IN, H = 40, 6, 32, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"i2h_w": rng.standard_normal((IN, H)).astype(np.float32) / np.sqrt(IN),
              "i2h_b": rng.standard_normal(H).astype(np.float32) * 0.1,
              "h2h_w": rng.standard_normal((H, H)).astype(np.float32) / np.sqrt(H),
              "h2h_b": rng.standard_normal(H).astype(np.float32) * 0.1}
    xs = rng.standard_normal((T, B, IN)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    lens = np.array([0, 1, T, 7, T // 2, T + 3], np.int32)
    return params, xs, h0, lens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("use_lens", [False, True])
@pytest.mark.parametrize("use_h0", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_basic_rnn_scan_matches_jax(dt, use_h0, use_lens):
    t_dt, j_dt = DTYPES[dt]
    params, xs, h0, lens = _inputs()
    jp = {k: jnp.asarray(v).astype(j_dt) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(t_dt) for k, v in params.items()}
    want_all, want_last = jax_basic_rnn_scan(
        jp, jnp.asarray(xs).astype(j_dt), h0=jnp.asarray(h0) if use_h0 else None,
        seq_lengths=jnp.asarray(lens) if use_lens else None)
    rnn_scan.kernel_launches = 0
    got_all, got_last = basic_rnn_scan(
        tp, torch.from_numpy(xs).to(t_dt), h0=torch.from_numpy(h0) if use_h0 else None,
        seq_lengths=torch.from_numpy(lens) if use_lens else None)
    assert rnn_scan.kernel_launches == 0  # CPU tensors take the plain loop
    assert got_all.dtype == got_last.dtype == t_dt
    assert got_all.shape == (T, B, H) and got_last.shape == (B, H)
    tol = {"rtol": 1e-5, "atol": 1e-5} if dt == "float32" else {"rtol": 0, "atol": 2.0 ** -7}
    np.testing.assert_allclose(_f32(got_all), _f32(want_all), **tol)
    np.testing.assert_allclose(_f32(got_last), _f32(want_last), **tol)
    if use_lens:  # a row of length 0 keeps its initial state throughout
        start = h0[0] if use_h0 else np.zeros(H, np.float32)
        np.testing.assert_array_equal(_f32(got_all)[:, 0], np.broadcast_to(
            _f32(torch.from_numpy(start).to(t_dt)), (T, H)))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_loop_passes_its_own_step_check(dt):
    """rnn_scan_tolerance (the teacher-forced check chip_smoke.py holds K3
    to) accepts the plain loop, and catches a one-ulp-plus change."""
    params, xs, h0, lens = _inputs(1)
    xproj = torch.from_numpy(xs @ params["i2h_w"] + params["i2h_b"])
    w, b = torch.from_numpy(params["h2h_w"]).to(dt), torch.from_numpy(params["h2h_b"]).to(dt)
    h0_t, lens_t = torch.from_numpy(h0), torch.from_numpy(lens)
    all_h, _ = rnn_scan_reference(xproj, w, b, dt, h0=h0_t, seq_lengths=lens_t)
    step, tol = rnn_scan_tolerance(all_h, xproj, w, b, h0=h0_t, seq_lengths=lens_t)
    assert bool(((all_h.float() - step).abs() <= tol).all())
    bad = all_h.float().clone()
    bad[5, 2, 3] += 4 * tol[5, 2, 3] + 2.0 ** -6
    assert not bool(((bad - step).abs() <= tol).all())


def test_rnn_init_distributions():
    g = torch.Generator().manual_seed(0)
    p = basic_rnn_init(256, 64, torch.float32, g, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "i2h_w": (256, 64), "i2h_b": (64,), "h2h_w": (64, 64), "h2h_b": (64,)}
    np.testing.assert_allclose(p["i2h_w"].std().item(), 1 / 16, rtol=0.05)
    np.testing.assert_allclose(p["h2h_w"].std().item(), 1 / 8, rtol=0.05)
    assert not p["i2h_b"].any() and not p["h2h_b"].any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xproj = torch.zeros((3, 2, 64))
    w, b = torch.zeros((64, 64)), torch.zeros(64)
    with pytest.raises(ValueError, match="hidden size 64"):
        rnn_scan(torch.zeros((3, 2, 32)), w[:32, :32], b[:32], torch.float32)
    with pytest.raises(TypeError, match="xproj"):
        rnn_scan(xproj.bfloat16(), w, b, torch.float32)
    with pytest.raises(TypeError, match="share a dtype"):
        rnn_scan(xproj, w, b.bfloat16(), torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rnn_scan(xproj, w, b, torch.float16)
    with pytest.raises(ValueError, match="h2h_w"):
        rnn_scan(xproj, w[:, :32], b, torch.float32)
    with pytest.raises(TypeError, match="h0"):
        rnn_scan(xproj, w, b, torch.float32, h0=torch.zeros((3, 64)))
    with pytest.raises(TypeError, match="seq_lengths"):
        rnn_scan(xproj, w, b, torch.float32, seq_lengths=torch.ones(2))


def test_empty_sequence_returns_the_initial_state():
    h0 = torch.randn((2, 64))
    all_h, last = rnn_scan(torch.zeros((0, 2, 64)), torch.zeros((64, 64)), torch.zeros(64),
                           torch.bfloat16, h0=h0)
    assert all_h.shape == (0, 2, 64) and torch.equal(last, h0.bfloat16())
