"""The port's ops against the JAX package's, on the CPU, same numpy inputs.

Tolerances:
- f32 pooled sums: rtol 1e-6 (summation order differs; L <= 8 terms here).
- bf16 pooled sums: at most 1 bf16 ulp of the larger value, plus the f32
  summation slack L * 2^-23 * sum|rows| (both sides sum in f32 and round
  once, so only the order of the f32 sum differs).
- f32 MLPs: rtol 1e-5. bf16 MLPs: 2 bf16 ulps (2^-7 relative), since an f32
  product that lands near a rounding tie may round the other way at one
  layer and move the next layer's output by about one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu.ops import cat_interaction as jax_cat
from deeprecsys_tpu.ops import embedding_bag as jax_embedding_bag
from deeprecsys_tpu.ops import mlp_apply as jax_mlp_apply
from deeprecsys_tpu.ops import pack_table as jax_pack_table
from deeprecsys_tpu_torch.ops import (
    cat_interaction, embedding_bag, embedding_bag_reference, init_fused_tables,
    mlp_apply, mlp_init, unpack_table)

TABLE_ROWS = (50, 30, 20)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _lookup_inputs(d, B=4, L=5, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(sum(TABLE_ROWS), d)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(TABLE_ROWS)[:-1]]).astype(np.int32)
    indices = np.stack([np.stack([rng.integers(0, n, size=L) for n in TABLE_ROWS])
                        for _ in range(B)]).astype(np.int32)
    mask = rng.random(indices.shape) < 0.6 if masked else None
    return table, offsets, indices, mask


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("table_dt,compute_dt", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_embedding_bag_reference_matches_jax(table_dt, compute_dt, d, masked):
    table, offsets, indices, mask = _lookup_inputs(d, masked=masked)
    t_dt, j_dt = DTYPES[table_dt]
    tc_dt, jc_dt = DTYPES[compute_dt]
    want = _f32(jax_embedding_bag(
        jnp.asarray(table).astype(j_dt), jnp.asarray(offsets), jnp.asarray(indices),
        compute_dtype=jc_dt, mask=None if mask is None else jnp.asarray(mask)))
    got_t = embedding_bag_reference(
        torch.from_numpy(table).to(t_dt), torch.from_numpy(offsets),
        torch.from_numpy(indices), compute_dtype=tc_dt,
        mask=None if mask is None else torch.from_numpy(mask))
    assert got_t.dtype == tc_dt and got_t.shape == (4, 3, d)
    got = _f32(got_t)
    if compute_dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        rows = np.abs(_f32(torch.from_numpy(table).to(t_dt)))[
            (indices + offsets[None, :, None])]
        if mask is not None:
            rows = rows * mask[..., None]
        slack = indices.shape[-1] * 2.0 ** -23 * rows.sum(axis=2)
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
        assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_takes_plain_path(masked):
    table, offsets, indices, mask = _lookup_inputs(32, masked=masked)
    args = (torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(offsets),
            torch.from_numpy(indices))
    m = None if mask is None else torch.from_numpy(mask)
    embedding_bag.kernel_launches = 0
    got = embedding_bag(*args, mask=m)
    assert embedding_bag.kernel_launches == 0
    assert torch.equal(got, embedding_bag_reference(*args, mask=m))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, offsets, indices, _ = _lookup_inputs(32)
    t, o, i = (torch.from_numpy(table), torch.from_numpy(offsets),
               torch.from_numpy(indices))
    with pytest.raises(ValueError, match="d in"):
        embedding_bag(t[:, :16].contiguous(), o, i)
    with pytest.raises(TypeError, match="dtypes"):
        embedding_bag(t.double(), o, i)
    with pytest.raises(TypeError, match="indices"):
        embedding_bag(t, o, i.long())
    with pytest.raises(TypeError, match="offsets"):
        embedding_bag(t, o[:2], i)
    with pytest.raises(TypeError, match="mask"):
        embedding_bag(t, o, i, mask=torch.ones(i.shape, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(t, o, i.transpose(0, 2).contiguous().transpose(0, 2))
    with pytest.raises(TypeError, match="dtypes"):
        embedding_bag(t, o, i, compute_dtype=torch.float16)


@pytest.mark.parametrize("pack,rows_total", [(2, 100), (4, 101)])
def test_unpack_table_inverts_jax_pack(pack, rows_total):
    table = np.random.default_rng(1).normal(size=(rows_total, 8)).astype(np.float32)
    packed = np.array(jax_pack_table(jnp.asarray(table), pack))
    got = unpack_table(torch.from_numpy(packed), pack, rows_total)
    np.testing.assert_array_equal(got.numpy(), table)


def _mlp_params(dims, seed=2):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(n, m)).astype(np.float32) / np.sqrt(n),
             "b": rng.normal(size=(m,)).astype(np.float32) * 0.1}
            for n, m in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("sigmoid_layer,final_relu", [(-1, True), (3, True), (-1, False)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp_apply_matches_jax(dt, sigmoid_layer, final_relu):
    t_dt, j_dt = DTYPES[dt]
    np_params = _mlp_params((24, 16, 8, 4))
    x = np.random.default_rng(3).normal(size=(6, 24)).astype(np.float32)
    jp = [{k: jnp.asarray(v).astype(j_dt) for k, v in layer.items()} for layer in np_params]
    tp = [{k: torch.from_numpy(v).to(t_dt) for k, v in layer.items()} for layer in np_params]
    want = _f32(jax_mlp_apply(jp, jnp.asarray(x).astype(j_dt),
                              sigmoid_layer=sigmoid_layer, final_relu=final_relu))
    got_t = mlp_apply(tp, torch.from_numpy(x).to(t_dt),
                      sigmoid_layer=sigmoid_layer, final_relu=final_relu)
    assert got_t.dtype == t_dt
    got = _f32(got_t)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(want).max())
    if sigmoid_layer == 3:
        assert ((got > 0) & (got < 1)).all()
    elif not final_relu:
        assert (got < 0).any()  # the last pre-activation is exposed


def test_mlp_apply_bf16_adds_bias_in_f32():
    # (1 + 2^-7)(1 + 3*2^-7) = 1 + 2^-5 + 3*2^-14. Rounded to bf16 before
    # the bias it is 1 + 2^-5, and minus 1 gives 2^-5. Kept in f32 through
    # the bias it is 2^-5 (1 + 3*2^-9), which rounds once to 2^-5 (1 + 2^-7).
    x = np.array([[1 + 2.0 ** -7]], np.float32)
    w = np.array([[1 + 3 * 2.0 ** -7]], np.float32)
    b = np.array([-1.0], np.float32)
    bf = jnp.bfloat16
    want = _f32(jax_mlp_apply([{"w": jnp.asarray(w).astype(bf), "b": jnp.asarray(b).astype(bf)}],
                              jnp.asarray(x).astype(bf)))
    got = _f32(mlp_apply([{"w": torch.from_numpy(w).bfloat16(),
                           "b": torch.from_numpy(b).bfloat16()}],
                         torch.from_numpy(x).bfloat16()))
    assert got.item() == want.item() == 2.0 ** -5 * (1 + 2.0 ** -7)


@pytest.mark.parametrize("with_dense", [True, False])
def test_cat_interaction_matches_jax(with_dense):
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(3, 8)).astype(np.float32) if with_dense else None
    emb = rng.normal(size=(3, 5, 8)).astype(np.float32)
    want = np.asarray(jax_cat(None if dense is None else jnp.asarray(dense), jnp.asarray(emb)))
    got = cat_interaction(None if dense is None else torch.from_numpy(dense),
                          torch.from_numpy(emb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_init_fused_tables_scale_per_table(dt):
    g = torch.Generator().manual_seed(0)
    t = init_fused_tables([10, 1000], 32, dt, g, "cpu").float().numpy()
    assert t.shape == (1010, 32)
    # Each table within U(+-sqrt(1/n)) (reference init distribution) ...
    assert np.abs(t[:10]).max() <= np.sqrt(1 / 10) * (1 + 2 ** -8)
    assert np.abs(t[10:]).max() <= np.sqrt(1 / 1000) * (1 + 2 ** -8)
    # ... and filling it: the uniform's std is bound / sqrt(3).
    np.testing.assert_allclose(t[10:].std(), np.sqrt(1 / 1000) / np.sqrt(3), rtol=0.03)
    assert abs(t[10:].mean()) < 0.02 * np.sqrt(1 / 1000)


def test_mlp_init_distributions():
    g = torch.Generator().manual_seed(1)
    (layer,) = mlp_init((256, 512), torch.float32, g, "cpu")
    assert layer["w"].shape == (256, 512) and layer["b"].shape == (512,)
    np.testing.assert_allclose(layer["w"].std().item(), np.sqrt(2 / (256 + 512)), rtol=0.03)
    np.testing.assert_allclose(layer["b"].std().item(), np.sqrt(1 / 512), rtol=0.15)
    assert abs(layer["w"].mean().item()) < 0.01 * np.sqrt(2 / 768)
