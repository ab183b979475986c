"""The trainer's ops in the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's; for CPU
tensors every kernel wrapper runs its plain version:

- K1b (``embedding_bag_backward``, and ``embedding_bag`` under autograd)
  against ``jax.vjp`` of the JAX lookup, with a mask and ids that repeat
  many times: f32 within ``backward_tolerance`` (n_r * 2^-22 * sum|g| for a
  row of n_r adds: the two packages add a row's terms in other orders).
- K5 (``sparse_adagrad_step``) against the JAX step's own lines
  (``train.py:259-278``) on heavy duplicates: f32 accumulator and table
  within ``sparse_adagrad_tolerance`` (the same order argument, carried
  through rsqrt); a bf16 table within it too, each add rounding to bf16.
- K3b (``rnn_scan`` under autograd) against ``jax.vjp`` of JAX's
  ``basic_rnn_scan`` with ``seq_lengths`` and ``h0``: f32 within 1e-5 of
  each gradient's largest magnitude (sums of 64 products in other orders,
  carried over 40 steps, err in absolute terms); and
  the plain reverse scan against torch's autograd through the plain
  forward loop, an independent derivation.
- The losses and their gradients: rtol 1e-6 (elementwise f32 math).
- One optimizer step (two for adam) against optax on the same params and
  gradients: rtol 1e-6 (the port writes optax's ops in optax's order; one
  f32 rounding apart at most). The plain version of K10
  (``optimizer_update_reference``) on its own over two steps: f32 leaves
  against optax in f32, params and state, rtol 1e-6; bf16 leaves against
  optax in f32 on the same bf16 values, params within 2 bf16 ulps of each
  value plus 2^-6 * lr a step (the eager ops round every step's result to
  bf16, the update too before it is added, which near p = 0 is many ulps
  of p; optax in bf16 is no reference here: it rounds its own constants
  to bf16, b2 = 0.999 to 1.0).
- ``dot_interaction`` against JAX: f32 rtol 1e-6.
- The ownership windows' plain versions on the row shards of a 1x4 mesh:
  K1b's (``embedding_bag_backward_shard``, and ``embedding_bag_shard``
  under autograd) against ``jax.vjp`` of JAX's ``sharded_embedding_bag``,
  each shard within ``backward_tolerance(window=)``; K5's
  (``sparse_adagrad_step_shard``) against the JAX sharded step's masked
  scatters (``shard_local_indices``, ``train.py:164-182``) under
  ``shard_map``, within ``sparse_adagrad_tolerance(window=)``: f32 shards
  by the order of each row's adds, bf16 shards (each row's updates summed
  in f32 and the row rounded once, as JAX's sharded step does) by that f32
  order plus one bf16 ulp a row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprecsys_tpu.ops import basic_rnn_scan as jax_basic_rnn_scan
from deeprecsys_tpu.ops.embedding import embedding_bag as jax_embedding_bag
from deeprecsys_tpu.ops.interactions import dot_interaction as jax_dot_interaction
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel import sharding as jax_sharding
from deeprecsys_tpu.train import make_optimizer as jax_make_optimizer
from deeprecsys_tpu_torch.ops import (
    basic_rnn_scan, dot_interaction, embedding_bag, embedding_bag_backward,
    embedding_bag_backward_shard, embedding_bag_shard, rnn_scan, rnn_scan_backward_reference,
    rnn_scan_reference, sparse_adagrad_step, sparse_adagrad_step_shard)
from deeprecsys_tpu_torch.ops import optimizer as port_optimizer
from deeprecsys_tpu_torch.ops.embedding import backward_tolerance
from deeprecsys_tpu_torch.ops.optimizer import optimizer_update, optimizer_update_reference
from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_tolerance
from deeprecsys_tpu_torch.parallel import sharding
from deeprecsys_tpu_torch.train import make_optimizer


def _lookup_inputs(seed, B=16, T=3, L=20, rows=7, d=32):
    """Ids from a few rows a table, so each row repeats ~B*L/rows times."""
    rng = np.random.default_rng(seed)
    offsets = (np.arange(T) * rows).astype(np.int32)
    indices = rng.integers(0, rows, (B, T, L)).astype(np.int32)
    mask = rng.random((B, T, L)) < 0.7
    table = rng.standard_normal((T * rows, d)).astype(np.float32)
    g = rng.standard_normal((B, T, d)).astype(np.float32)
    return offsets, indices, mask, table, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_embedding_bag_backward_matches_jax_vjp(masked, d):
    offsets, indices, mask, table, g = _lookup_inputs(1, d=d)
    m = mask if masked else None
    _, vjp = jax.vjp(lambda t: jax_embedding_bag(
        t, jnp.asarray(offsets), jnp.asarray(indices),
        mask=None if m is None else jnp.asarray(m)), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tm = None if m is None else torch.from_numpy(m)
    args = (torch.from_numpy(g), torch.from_numpy(offsets), torch.from_numpy(indices))
    got = embedding_bag_backward(*args, table.shape[0], mask=tm)
    tol = backward_tolerance(*args, table.shape[0], tm).numpy()
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= tol)
    # Through autograd: embedding_bag on a table that requires grad.
    t = torch.from_numpy(table).requires_grad_(True)
    out = embedding_bag(t, args[1], args[2], mask=tm)
    assert out.grad_fn is not None
    (out * args[0]).sum().backward()
    assert np.all(np.abs(t.grad.numpy() - want) <= tol)


def test_embedding_bag_routes_through_autograd_only_under_grad():
    offsets, indices, _, table, _ = _lookup_inputs(2)
    off, idx = torch.from_numpy(offsets), torch.from_numpy(indices)
    t = torch.from_numpy(table)
    assert embedding_bag(t, off, idx).grad_fn is None
    t.requires_grad_(True)
    with torch.inference_mode():
        assert embedding_bag(t, off, idx).grad_fn is None
    with torch.no_grad():
        assert embedding_bag(t, off, idx).grad_fn is None
    # A bf16 table gets its gradient in bf16.
    tb = torch.from_numpy(table).bfloat16().requires_grad_(True)
    embedding_bag(tb, off, idx, compute_dtype=torch.float32).sum().backward()
    assert tb.grad.dtype == torch.bfloat16


def _jax_sparse_step(table, acc, offsets, indices, g_pooled, lr, eps=1e-8):
    """The sparse half of JAX ``make_sparse_table_step`` (``train.py:259-278``)."""
    B, T, L = indices.shape
    flat = (jnp.asarray(indices) + jnp.asarray(offsets)[None, :, None]).reshape(-1)
    g_rows = jnp.broadcast_to(jnp.asarray(g_pooled)[:, :, None, :].astype(jnp.float32),
                              (B, T, L, g_pooled.shape[-1])).reshape(B * T * L, -1)
    row_g2 = jnp.mean(g_rows * g_rows, axis=-1)
    acc = jnp.asarray(acc).at[flat].add(row_g2)
    scale = jax.lax.rsqrt(acc[flat] + eps)
    g_rows = g_rows * scale[:, None]
    table = jnp.asarray(table)
    table = table.at[flat].add((-lr * g_rows).astype(table.dtype))
    return np.asarray(table.astype(jnp.float32)), np.asarray(acc)


@pytest.mark.parametrize("table_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
def test_sparse_adagrad_matches_the_jax_step(d, table_dt):
    offsets, indices, _, table, g = _lookup_inputs(3, d=d)
    rng = np.random.default_rng(4)
    acc0 = (rng.random(table.shape[0]) * 1e-3).astype(np.float32)
    g = g * np.float32(0.05)
    jt = jnp.asarray(table).astype(table_dt)
    want_t, want_a = _jax_sparse_step(jt, acc0, offsets, indices, g, 0.1)
    t0 = torch.from_numpy(table).to(getattr(torch, table_dt))
    t, acc = t0.clone(), torch.from_numpy(acc0.copy())
    args = (torch.from_numpy(offsets), torch.from_numpy(indices), torch.from_numpy(g))
    sparse_adagrad_step(t, acc, *args, 0.1)
    tol, acc_tol = sparse_adagrad_tolerance(t0, torch.from_numpy(acc0), *args, 0.1)
    assert np.all(np.abs(acc.numpy() - want_a) <= acc_tol.numpy())
    assert np.all(np.abs(t.float().numpy() - want_t) <= tol.numpy())
    assert t.dtype == t0.dtype


def _rnn_inputs(seed, T=40, B=6, IN=32, H=64):
    rng = np.random.default_rng(seed)
    params = {"i2h_w": rng.standard_normal((IN, H)) / np.sqrt(IN),
              "i2h_b": rng.standard_normal(H) * 0.1,
              "h2h_w": rng.standard_normal((H, H)) / np.sqrt(H),
              "h2h_b": rng.standard_normal(H) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    xs = rng.standard_normal((T, B, IN)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    lens = np.array([0, 1, T, 7, T // 2, T + 3], np.int32)[:B]
    g_all = rng.standard_normal((T, B, H)).astype(np.float32)
    g_last = rng.standard_normal((B, H)).astype(np.float32)
    return params, xs, h0, lens, g_all, g_last


@pytest.mark.parametrize("H", [4, 8, 64])
@pytest.mark.parametrize("use_lens", [False, True])
@pytest.mark.parametrize("use_h0", [False, True])
def test_rnn_scan_gradients_match_jax_vjp(use_h0, use_lens, H):
    params, xs, h0, lens, g_all, g_last = _rnn_inputs(5, H=H)
    h0 = h0 if use_h0 else None
    lens = lens if use_lens else None

    def jax_fn(p, x, h):
        return jax_basic_rnn_scan(p, x, h0=h, seq_lengths=None if lens is None
                                  else jnp.asarray(lens))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jh = None if h0 is None else jnp.asarray(h0)
    _, vjp = jax.vjp(jax_fn, jp, jnp.asarray(xs), jh)
    want_p, want_x, want_h = vjp((jnp.asarray(g_all), jnp.asarray(g_last)))

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(xs.copy()).requires_grad_(True)
    th = None if h0 is None else torch.from_numpy(h0.copy()).requires_grad_(True)
    all_h, last = basic_rnn_scan(tp, tx, h0=th,
                                 seq_lengths=None if lens is None else torch.from_numpy(lens))
    (all_h * torch.from_numpy(g_all)).sum().add((last * torch.from_numpy(g_last)).sum()).backward()
    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    for k in params:
        close(tp[k].grad, want_p[k])
    close(tx.grad, want_x)
    if h0 is not None:
        close(th.grad, want_h)


def test_rnn_scan_backward_reference_matches_autograd_of_the_plain_loop():
    """An independent derivation: torch's autograd through the plain
    forward loop (``rnn_scan_reference``) gives the same gradients of
    ``xproj`` and ``h0`` as the reverse scan."""
    params, _, h0, lens, g_all, _ = _rnn_inputs(6)
    rng = np.random.default_rng(7)
    xproj = torch.from_numpy(rng.standard_normal(g_all.shape).astype(np.float32))
    w, b = torch.from_numpy(params["h2h_w"]), torch.from_numpy(params["h2h_b"])
    x = xproj.clone().requires_grad_(True)
    h = torch.from_numpy(h0).requires_grad_(True)
    lens_t = torch.from_numpy(lens)
    all_h, _ = rnn_scan_reference(x, w, b, torch.float32, h0=h, seq_lengths=lens_t)
    (all_h * torch.from_numpy(g_all)).sum().backward()
    with torch.no_grad():
        prev = torch.cat([h[None], all_h[:-1]])
        y = torch.tanh((xproj + prev @ w) + b)
    delta, dh0 = rnn_scan_backward_reference(y, torch.from_numpy(g_all), w, lens_t)
    torch.testing.assert_close(delta, x.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh0, h.grad, rtol=1e-5, atol=1e-6)


def test_rnn_scan_routes_through_autograd_only_under_grad():
    params, _, _, _, g_all, _ = _rnn_inputs(8)
    x = torch.from_numpy(g_all)
    w, b = torch.from_numpy(params["h2h_w"]), torch.from_numpy(params["h2h_b"])
    all_h, last = rnn_scan(x, w, b, torch.float32)
    assert all_h.grad_fn is None and last.grad_fn is None
    all_h, last = rnn_scan(x, w.requires_grad_(True), b, torch.float32)
    assert all_h.grad_fn is not None and last.grad_fn is not None
    with torch.inference_mode():
        assert rnn_scan(x, w, b, torch.float32)[0].grad_fn is None


@pytest.mark.parametrize("name,sigmoid", [("bce", True), ("bce", False), ("mse", True)])
def test_losses_and_gradients_match_jax(name, sigmoid):
    rng = np.random.default_rng(9)
    if sigmoid:  # probabilities, some past the 1e-7 clip at both ends
        s = rng.random((64, 2)).astype(np.float32)
        s[:3, 0] = [0.0, 1.0, 1e-9]
    else:
        s = (rng.standard_normal((64, 2)) * 4).astype(np.float32)
    t = (rng.random((64, 2)) < 0.5).astype(np.float32)
    jfn = jax_sharding.loss_fn_for(name, sigmoid)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(s), jnp.asarray(t))
    ts = torch.from_numpy(s).requires_grad_(True)
    got = sharding.loss_fn_for(name, sigmoid)(ts, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)
    if sigmoid and name == "bce":  # the clip's VJP: no gradient outside it
        assert not ts.grad[:3, 0].any()


def test_loss_fn_for_rejects_unknown():
    with pytest.raises(ValueError, match="unknown loss"):
        sharding.loss_fn_for("hinge", True)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_steps_match_optax(name):
    """The parameter delta of one step (two for adam: its bias correction
    at count 2) on the same params and gradients."""
    rng = np.random.default_rng(10)
    params = {"w": rng.standard_normal((33, 17)).astype(np.float32),
              "b": rng.standard_normal(17).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 1, v.shape)
                  ).astype(np.float32) for k, v in params.items()} for _ in range(2)]
    tx = jax_make_optimizer(name, 0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    opt = make_optimizer(name, 0.05)
    leaves = [torch.from_numpy(params[k].copy()) for k in ("w", "b")]
    pstate = opt.init(leaves)
    for g in grads[:2 if name == "adam" else 1]:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(leaves, [torch.from_numpy(g[k]) for k in ("w", "b")], pstate)
    for k, got in zip(("w", "b"), leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def _optax_state_lists(name, state):
    """optax's state of one of sgd, adagrad, adam as the port's state lists
    (leaves ``w``, ``b``)."""
    if name == "sgd":
        return []
    if name == "adagrad":
        return [[state[0].sum_of_squares[k] for k in ("w", "b")]]
    return [[state[0].mu[k] for k in ("w", "b")], [state[0].nu[k] for k in ("w", "b")]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_update_reference_matches_optax(name, dtype):
    """K10's plain version, called on its own, against optax's update and
    apply_updates in f32 on the same leaves and gradients (bf16 values for
    bf16 leaves), two steps (see the module note for the bounds)."""
    rng = np.random.default_rng(12)
    tdt = getattr(torch, dtype)
    as_dt = lambda x: torch.from_numpy(x).to(tdt)  # noqa: E731
    params = {"w": rng.standard_normal((33, 17)).astype(np.float32),
              "b": rng.standard_normal(17).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-4, 1, v.shape)
                  ).astype(np.float32) for k, v in params.items()} for _ in range(2)]
    exact = lambda x: as_dt(x).float().numpy()  # noqa: E731  (the leaf's values in f32)
    tx = jax_make_optimizer(name, 0.05)
    jp = {k: jnp.asarray(exact(v)) for k, v in params.items()}
    state = tx.init(jp)
    leaves = [as_dt(params[k]) for k in ("w", "b")]
    init = make_optimizer(name, 0.05).init(leaves)
    states = ([] if init is None else [init] if name == "adagrad" else [init["mu"], init["nu"]])
    for count, g in enumerate(grads, start=1):
        upd, state = tx.update({k: jnp.asarray(exact(v)) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        optimizer_update_reference(name, leaves, [as_dt(g[k]) for k in ("w", "b")], states, 0.05,
                                   count)
    if dtype == "float32":
        got = leaves + [t for s in states for t in s]
        want = [jp[k] for k in ("w", "b")] + [t for s in _optax_state_lists(name, state) for t in s]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        return
    for a, k in zip(leaves, ("w", "b")):
        assert a.dtype == torch.bfloat16
        b = np.asarray(jp[k])
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(a.float().numpy() - b),
                                     2 * ulp + len(grads) * 0.05 * 2.0 ** -6)


def test_optimizer_update_takes_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    plain = port_optimizer.optimizer_update_reference
    monkeypatch.setattr(port_optimizer, "optimizer_update_reference",
                        lambda *a, **k: calls.append(a[0]) or plain(*a, **k))
    tx = make_optimizer("adagrad", 0.1)
    leaves = [torch.ones(5), torch.ones(2, 3)]
    state = tx.init(leaves)
    before = optimizer_update.kernel_launches
    tx.update(leaves, [torch.full((5,), 0.5), torch.full((2, 3), 0.5)], state)
    assert calls == ["adagrad"] and optimizer_update.kernel_launches == before
    want = 1 - 0.1 * 0.5 / np.sqrt(np.float32(0.1) + np.float32(0.25) + np.float32(1e-7))
    np.testing.assert_allclose(leaves[0].numpy(), np.full(5, want, np.float32), rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_optimizer_update_raises_off_cpu_and_cuda(name):
    """A meta tensor is neither: the update raises rather than falling back."""
    tx = make_optimizer(name, 0.1)
    leaves = [torch.empty((4, 4), device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tx.update(leaves, [torch.empty((4, 4), device="meta")], tx.init(leaves))


def test_optimizer_update_checks_its_leaves():
    p, g = torch.zeros(4), torch.zeros(4)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer_update("rmsprop", [p], [g], [], 0.1)
    with pytest.raises(ValueError, match="state lists"):
        optimizer_update("adagrad", [p], [g], [], 0.1)
    with pytest.raises(ValueError, match="does not match"):
        optimizer_update("sgd", [p], [torch.zeros(5)], [], 0.1)
    with pytest.raises(ValueError, match="does not match"):
        optimizer_update("adagrad", [p], [g], [[torch.zeros(4, dtype=torch.bfloat16)]], 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        optimizer_update("sgd", [p.double()], [g.double()], [], 0.1)
    optimizer_update("sgd", [], [], [], 0.1)  # no leaves: nothing to do


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("rmsprop", 0.1)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_jax(self_interaction):
    rng = np.random.default_rng(11)
    dense = rng.standard_normal((8, 16)).astype(np.float32)
    emb = rng.standard_normal((8, 5, 16)).astype(np.float32)
    want = np.asarray(jax_dot_interaction(jnp.asarray(dense), jnp.asarray(emb),
                                          self_interaction=self_interaction))
    got = dot_interaction(torch.from_numpy(dense), torch.from_numpy(emb),
                          self_interaction=self_interaction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- the ownership windows

SHARDS = 4


def _jax_shard_mesh():
    return jax_make_mesh(data=1, model=SHARDS, devices=jax.devices()[:SHARDS])


@pytest.mark.parametrize("d", [32, 64])
def test_embedding_bag_backward_window_matches_jax_sharded_vjp(d):
    """Each row shard's gradient (rows 6 a shard: the shards cut through
    the tables) against the VJP of JAX's row-sharded lookup."""
    offsets, indices, mask, table, g = _lookup_inputs(6, rows=8, d=d)
    R = table.shape[0]
    rps = R // SHARDS
    mesh = _jax_shard_mesh()

    @jax.jit
    def vjp(t, gp):
        return jax.vjp(lambda t_: jax_sharding.sharded_embedding_bag(
            t_, jnp.asarray(offsets), jnp.asarray(indices), mesh, R), t)[1](gp)[0]

    want = np.asarray(vjp(jnp.asarray(table), jnp.asarray(g)))
    args = (torch.from_numpy(g), torch.from_numpy(offsets), torch.from_numpy(indices))
    shards = [torch.from_numpy(table[m * rps:(m + 1) * rps]).requires_grad_(True)
              for m in range(SHARDS)]
    pooled = sum(embedding_bag_shard(t, args[1], args[2], m * rps) for m, t in enumerate(shards))
    assert pooled.grad_fn is not None
    (pooled * args[0]).sum().backward()
    for m, t in enumerate(shards):
        w = (m * rps, (m + 1) * rps)
        got = embedding_bag_backward_shard(*args, m * rps, rps)
        tol = backward_tolerance(*args, rps, window=w).numpy()
        assert got.shape == (rps, d) and got.dtype == torch.float32
        assert np.all(np.abs(got.numpy() - want[w[0]:w[1]]) <= tol)
        assert np.all(np.abs(t.grad.numpy() - want[w[0]:w[1]]) <= tol)
    # With a mask: the window of the masked single-device gradient.
    tm = torch.from_numpy(mask)
    full = embedding_bag_backward(*args, R, mask=tm)
    for m in range(SHARDS):
        got = embedding_bag_backward_shard(*args, m * rps, rps, mask=tm)
        assert torch.equal(got, full[m * rps:(m + 1) * rps])


def _jax_sharded_scatters(table, acc, offsets, indices, g_pooled, lr, eps=1e-8):
    """The JAX sharded sparse step's masked scatters (``train.py:164-182``)
    on each row shard of a 1x4 mesh, under ``shard_map``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rps = table.shape[0] // SHARDS

    def local(table_shard, acc_shard, idx, g):
        safe, valid = jax_sharding.shard_local_indices(idx, jnp.asarray(offsets), rps)
        B, T, L = idx.shape
        g_rows = jnp.broadcast_to(g[:, :, None, :].astype(jnp.float32),
                                  (B, T, L, g.shape[-1])).reshape(B * T * L, -1)
        flat, maskf = safe.reshape(-1), valid.reshape(-1)
        g_rows = jnp.where(maskf[:, None], g_rows, 0.0)
        row_g2 = jnp.where(maskf, jnp.mean(g_rows * g_rows, axis=-1), 0.0)
        acc_shard = acc_shard.at[flat].add(row_g2)
        scale = jax.lax.rsqrt(acc_shard[flat] + eps)
        table_shard = table_shard.astype(jnp.float32).at[flat].add(
            -lr * g_rows * scale[:, None]).astype(table_shard.dtype)
        return table_shard, acc_shard

    fn = jax.jit(shard_map(local, mesh=_jax_shard_mesh(),
                   in_specs=(P("model", None), P("model"), P(), P()),
                   out_specs=(P("model", None), P("model")), check_vma=False))
    t, a = fn(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(indices), jnp.asarray(g_pooled))
    return np.asarray(t.astype(jnp.float32)), np.asarray(a)


@pytest.mark.parametrize("table_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
def test_sparse_adagrad_window_matches_jax_masked_scatters(d, table_dt):
    offsets, indices, _, table, g = _lookup_inputs(7, rows=8, d=d)
    R = table.shape[0]
    rps = R // SHARDS
    rng = np.random.default_rng(8)
    acc0 = (rng.random(R) * 1e-3).astype(np.float32)
    g = g * np.float32(0.05)
    jt = jnp.asarray(table).astype(table_dt)
    want_t, want_a = _jax_sharded_scatters(jt, acc0, offsets, indices, g, 0.1)
    t0 = torch.from_numpy(table).to(getattr(torch, table_dt))
    args = (torch.from_numpy(offsets), torch.from_numpy(indices), torch.from_numpy(g))
    for m in range(SHARDS):
        w = (m * rps, (m + 1) * rps)
        shard0, a0 = t0[w[0]:w[1]], torch.from_numpy(acc0[w[0]:w[1]].copy())
        shard, acc = shard0.clone(), a0.clone()
        sparse_adagrad_step_shard(shard, acc, *args, m * rps, 0.1)
        # A bf16 shard: both sum a row's updates in f32 and round the row
        # once, so the bound is the f32 sums' order plus one bf16 ulp a row.
        tol, acc_tol = sparse_adagrad_tolerance(shard0, a0, *args, 0.1, window=w)
        assert shard.dtype == shard0.dtype
        assert np.all(np.abs(acc.numpy() - want_a[w[0]:w[1]]) <= acc_tol.numpy())
        assert np.all(np.abs(shard.float().numpy() - want_t[w[0]:w[1]]) <= tol.numpy())

