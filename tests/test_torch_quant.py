"""The port's int8 tables against the JAX package on the CPU: the ops
(per-table ``embedding_bag_int8``, row-wise ``embedding_bag_int8_rowwise``,
``dequant_packed_rows``, the inits), every zoo model in both modes, the
parity fixture ``tests/golden/torch_port_quant.npz``, and the trainer's
int8 exports served through ``main.py --checkpoint --table_quant`` and
``run_serving``.

Tolerances:
- per-table int8: equal bit for bit. Both packages sum the int8 rows in
  exact int32, then make one f32 multiply by the table's scale and one
  rounding to the compute dtype.
- row-wise int8: ``rowwise_tolerance``. The products are the same f32
  roundings; only the order of the f32 sum over L differs.
- ``dequant_packed_rows`` and the inits' scales: bit for bit.
- models: the zoo fixture's (f32 rtol and atol 1e-5; bf16 two bf16 ulps
  of the output's largest magnitude, ``chip_smoke.bf16_atol``).
- served exports: the scores of ``model.apply`` on ``checkpoint_params``
  of the same bundle exactly (the same tensors through the same forward).
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.models.base import pooled_lookup as jax_pooled_lookup
from deeprecsys_tpu.ops import embedding as jax_emb
from deeprecsys_tpu_torch import ServingConfig, bridge, train, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch, pooled_lookup
from deeprecsys_tpu_torch.ops import (
    dequant_packed_rows, embedding_bag_int8, embedding_bag_int8_reference,
    embedding_bag_int8_rowwise, embedding_bag_int8_rowwise_reference, init_fused_tables_int8,
    init_fused_tables_int8_rowwise)
from deeprecsys_tpu_torch.ops.embedding import (
    K1_WARPS_PER_BLOCK, k1_launch_plan, k4_launch_plan, rowwise_tolerance)
from deeprecsys_tpu_torch.serving import run_serving
from deeprecsys_tpu_torch.utils import checkpoint
from tests.golden import make_torch_port_fixture as fixture
from tests.test_torch_ops import _k1_coverage

SCALE = 2000
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
INT8_CU = Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc" / \
    "embedding_bag_int8.cu"


def _cfg(name, dtype="float32", **kw):
    return zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype, **kw)


def _jax_cfg(name, dtype="float32", **kw):
    return jax_zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype,
                              **kw)


def _int8_inputs(name, seed=0, B=6, masked=False):
    """A zoo model's offsets and ids at table_scale 2000, random int8 values,
    per-table scales and per-row scales, as numpy."""
    cfg = _cfg(name)
    rng = np.random.default_rng(seed)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    q = rng.integers(-127, 127, (R, d), dtype=np.int8, endpoint=True)
    scale = (rng.random(cfg.num_tables, dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    row_scale = (rng.random(R, dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    qrows = np.concatenate([q, row_scale.view(np.int8).reshape(R, 4)], axis=1)
    indices = RecDataGenerator(cfg, seed=seed + 1).generate_batch(B).indices
    mask = rng.random(indices.shape) < 0.6 if masked else None
    return q, scale, qrows, cfg.table_offsets, indices, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- the ops

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,layout", [("rm1", "q_packed"), ("rm1", "q"), ("rm2", "q"),
                                         ("din", "q_packed")])
def test_int8_lookup_equals_jax_bitwise(name, layout, dtype, masked):
    """JAX's pooled_lookup on {"q", "scale"} or {"q_packed", "scale"} (pack
    4 at d = 32) against the port's, the packed table through
    bridge.params_from_numpy."""
    q, scale, _, offsets, indices, mask = _int8_inputs(name, seed=3, masked=masked)
    jcfg = _jax_cfg(name, dtype, table_quant="int8")
    cfg = _cfg(name, dtype, table_quant="int8")
    if layout == "q_packed":
        assert cfg.resolved_table_pack == jcfg.resolved_table_pack == 4
        np_tables = {"q_packed": np.asarray(jax_emb.pack_table(jnp.asarray(q), 4)),
                     "scale": scale}
    else:
        np_tables = {"q": q, "scale": scale}
    want = jax_pooled_lookup({k: jnp.asarray(v) for k, v in np_tables.items()},
                             JaxBatch(None, jnp.asarray(indices),
                                      None if mask is None else jnp.asarray(mask)), jcfg)
    tables = bridge.params_from_numpy({"tables": np_tables}, cfg, "cpu")["tables"]
    assert sorted(tables) == ["q", "scale"] and tables["q"].shape == q.shape
    got = pooled_lookup(tables, Batch(None, _t(indices), _t(mask)), cfg)
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["rm1", "rm2", "wnd"])
def test_rowwise_lookup_matches_jax(name, dtype, masked):
    _, _, qrows, offsets, indices, mask = _int8_inputs(name, seed=4, masked=masked)
    t_dt, j_dt = DTYPES[dtype]
    want = jax_emb.embedding_bag_int8_rowwise(
        jnp.asarray(qrows), jnp.asarray(offsets), jnp.asarray(indices), compute_dtype=j_dt,
        mask=None if mask is None else jnp.asarray(mask))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    qr, off, idx, m = _t(qrows), _t(offsets), _t(indices), _t(mask)
    got = embedding_bag_int8_rowwise(qr, off, idx, compute_dtype=t_dt, mask=m)
    assert got.dtype == t_dt
    tol = rowwise_tolerance(got, want.to(t_dt), qr, off, idx, m)
    assert bool(((got.float() - want).abs() <= tol).all())
    # ... and through the models' dispatch.
    cfg = _cfg(name, dtype, table_quant="int8_rowwise")
    assert torch.equal(pooled_lookup({"qrows": qr}, Batch(None, idx, m), cfg), got)


def test_dequant_packed_rows_equals_jax_bitwise():
    _, _, qrows, *_ = _int8_inputs("rm2", seed=5)
    want = np.asarray(jax_emb.dequant_packed_rows(jnp.asarray(qrows)))
    got = dequant_packed_rows(_t(qrows)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrappers_take_the_plain_path(masked):
    q, scale, qrows, offsets, indices, mask = _int8_inputs("rm3", seed=6, masked=masked)
    args = (_t(offsets), _t(indices))
    embedding_bag_int8.kernel_launches = embedding_bag_int8_rowwise.kernel_launches = 0
    got = embedding_bag_int8(_t(q), _t(scale), *args, mask=_t(mask))
    got_rw = embedding_bag_int8_rowwise(_t(qrows), *args, mask=_t(mask))
    assert embedding_bag_int8.kernel_launches == embedding_bag_int8_rowwise.kernel_launches == 0
    assert torch.equal(got, embedding_bag_int8_reference(_t(q), _t(scale), *args, mask=_t(mask)))
    assert torch.equal(got_rw, embedding_bag_int8_rowwise_reference(_t(qrows), *args,
                                                                     mask=_t(mask)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, scale, qrows, offsets, indices, _ = _int8_inputs("rm1")
    q, s, qr, o, i = _t(q), _t(scale), _t(qrows), _t(offsets), _t(indices)
    with pytest.raises(TypeError, match="int8"):
        embedding_bag_int8(q.float(), s, o, i)
    with pytest.raises(TypeError, match="int8"):
        embedding_bag_int8_rowwise(qr.to(torch.int16), o, i)
    # Any width d >= 1 computes; a row-wise row holds d values and 4 scale bytes.
    with pytest.raises(ValueError, match=r"w >= 1"):
        embedding_bag_int8(q[:, :0].contiguous(), s, o, i)
    with pytest.raises(ValueError, match=r"w >= 5"):
        embedding_bag_int8_rowwise(q[:, :4].contiguous(), o, i)  # scale bytes, no values
    with pytest.raises(TypeError, match="scale"):
        embedding_bag_int8(q, s[:3], o, i)
    with pytest.raises(TypeError, match="scale"):
        embedding_bag_int8(q, s.double(), o, i)
    with pytest.raises(TypeError, match="compute dtype"):
        embedding_bag_int8(q, s, o, i, compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="compute dtype"):
        embedding_bag_int8_rowwise(qr, o, i, compute_dtype=torch.int32)
    with pytest.raises(TypeError, match="indices"):
        embedding_bag_int8_rowwise(qr, o, i.long())
    with pytest.raises(TypeError, match="mask"):
        embedding_bag_int8(q, s, o, i, mask=torch.ones(i.shape, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_int8_rowwise(qr.t().contiguous().t(), o, i)
    # Row-wise rows hold an f32 scale: a table off a 4-byte boundary is refused.
    base = torch.zeros((qr.numel() + 2,), dtype=torch.int8)
    with pytest.raises(ValueError, match="4-byte"):
        embedding_bag_int8_rowwise(base[2:].view(qr.shape), o, i)
    with pytest.raises(ValueError, match="unknown table layout"):
        pooled_lookup({"q_packed": q, "scale": s}, Batch(None, i), _cfg("rm1"))


# ---------------------------------------------------------------- the inits

def test_port_inits_have_jax_layout_range_and_scales():
    rows, d = (10, 1000, 37), 32
    g = torch.Generator().manual_seed(0)
    t = init_fused_tables_int8(rows, d, g, "cpu")
    want = jax_emb.init_fused_tables_int8(jax.random.PRNGKey(0), rows, d)
    assert t["q"].shape == want["q"].shape and t["q"].dtype == torch.int8
    assert t["scale"].numpy().tobytes() == np.asarray(want["scale"]).tobytes()
    assert int(t["q"].min()) == -127 and int(t["q"].max()) == 127
    rw = init_fused_tables_int8_rowwise(rows, d, g, "cpu")
    want_rw = np.asarray(jax_emb.init_fused_tables_int8_rowwise(jax.random.PRNGKey(0), rows, d))
    assert rw.shape == want_rw.shape == (sum(rows), d + 4) and rw.dtype == torch.int8
    assert rw[:, d:].numpy().tobytes() == want_rw[:, d:].tobytes()
    assert int(rw[:, :d].min()) == -127 and int(rw[:, :d].max()) == 127
    # Uniform on the grid: the mean of |q| of U{-127..127} is 64 * 127 / 127.5.
    assert abs(float(t["q"].float().abs().mean()) - 64 * 127 / 127.5) < 1.0


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_init_numpy_and_port_init_match_jax_init(name, quant):
    """bridge.init_numpy and the port's init (carried back by
    params_to_numpy) give JAX init's tree, shapes and dtypes (q_packed
    where the config resolves to pack > 1), and the same scale bytes."""
    cfg, jcfg = _cfg(name, table_quant=quant), _jax_cfg(name, table_quant=quant)
    jp = jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(0)))

    def shapes(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return treedef, [(tuple(x.shape), np.dtype(x.dtype)) for x in leaves]

    np_tree = bridge.init_numpy(cfg, 0)
    port = bridge.params_to_numpy(get_model(cfg, "cpu").init(torch.Generator().manual_seed(0)),
                                  cfg)
    for tree in (np_tree, port):
        assert shapes(tree) == shapes(jp)
        tables = tree["tables"]
        if quant == "int8":
            assert tables["scale"].tobytes() == jp["tables"]["scale"].tobytes()
        else:
            d = cfg.sparse_feature_size
            assert tables["qrows"][:, d:].tobytes() == jp["tables"]["qrows"][:, d:].tobytes()


# ---------------------------------------------------- the kernels' arithmetic

def test_int8_kernel_instances_match_the_plans():
    """The (lanes a row, bags a warp, rows a lane, load hint) instances
    embedding_bag_int8.cu builds are the ones k1_launch_plan(...,
    torch.int8) and k4_launch_plan pick. K1-int8: 16 bytes a lane (LPR = D
    / 16), a slot a bag with U 1 (no hint) or 2 (the hint), and for long bags
    a warp a bag with U = 2 (d = 32) or 4 bags a warp with U = 4 (d = 64).
    K4: a slot a bag of 8 values a lane with U 1, or of 16 with U 2 and
    the hint, and for long bags 16 values a lane, a warp a bag with U 2 (d =
    32) or 4 bags a warp with U 3 (d = 64)."""
    src = INT8_CU.read_text()
    assert re.search(rf"kWarpsPerBlock = {K1_WARPS_PER_BLOCK};", src)
    assert re.search(r"constexpr int LPR = D / 16;", src)
    assert len(re.findall(r"constexpr int GL = D == 32 \? 1 : 4;", src)) == 2
    assert re.search(r"constexpr int UL = D == 32 \? 2 : 4;", src)
    assert re.search(r"constexpr int UL = D == 32 \? 2 : 3;", src)
    assert set(re.findall(r"launch_int8<TC, D, LPR, (S|GL), (\w+), (true|false), kWindow>",
                          src)) == {
        ("S", "1", "false"), ("S", "2", "true"), ("GL", "UL", "false")}
    assert re.search(r"constexpr int S8 = 256 / D;", src)
    assert re.search(r"constexpr int S16 = 512 / D;", src)
    assert set(re.findall(r"launch_rowwise<TC, D, D / (\d+), (S8|S16|GL), (\w+), (true|false), "
                          r"kWindow>", src)) == {
        ("8", "S8", "1", "false"), ("16", "S16", "2", "true"), ("16", "GL", "UL", "false")}


def _plans(kernel, n_bags, L, d):
    if kernel == "K1-int8":
        plan = k1_launch_plan(n_bags, L, d, torch.int8)
        assert plan.row_slots == 512 // d
        allowed = {(512 // d, 1), (512 // d, 2), (1, 2) if d == 32 else (4, 4)}
    else:
        plan = k4_launch_plan(n_bags, L, d)
        assert plan.row_slots == (256 // d if L <= 1 else 512 // d)
        allowed = {(256 // d, 1), (512 // d, 2), (1, 2) if d == 32 else (4, 3)}
    assert (plan.bags_per_warp, plan.rows_per_lane) in allowed
    return plan


@pytest.mark.parametrize("grid_cap", [None, 3])
@pytest.mark.parametrize("kernel", ["K1-int8", "K4"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 20, 80, 120])
@pytest.mark.parametrize("n_bags", [1, 13, 1001])
def test_int8_plans_cover_every_bag_and_row_once(n_bags, L, d, kernel, grid_cap):
    """The kernels' index arithmetic (the same as K1's, simulated by
    test_torch_ops._k1_coverage) under each plan, also with the grid capped
    so that warps loop over several tasks."""
    plan = _plans(kernel, n_bags, L, d)
    if L <= 8:
        assert plan.bags_per_warp == plan.row_slots and plan.rows_per_lane == min(L, 2)
    if grid_cap is not None:
        plan = dataclasses.replace(plan, grid=min(plan.grid, grid_cap))
    reads, writes = _k1_coverage(plan, n_bags, L)
    assert (reads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("kernel", ["K1-int8", "K4"])
@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_int8_plans_cover_every_zoo_bag_once(name, kernel):
    cfg = zoo.get_config(name)
    n_bags, L = 512 * cfg.num_tables, cfg.num_indices_per_lookup
    plan = _plans(kernel, n_bags, L, cfg.sparse_feature_size)
    assert plan.grid * K1_WARPS_PER_BLOCK >= plan.tasks > (plan.grid - 1) * K1_WARPS_PER_BLOCK
    reads, writes = _k1_coverage(plan, n_bags, L)
    assert (reads == 1).all() and (writes == 1).all()


# The kernels' addressing and arithmetic, simulated in Python as
# embedding_bag_int8.cu does it (the card runs the real thing).

def test_k4_values_from_offset_binary_bytes_are_exact():
    """K4's value of a byte: its offset-binary byte under 2^23's exponent
    (__byte_perm(y, 0x4b000000, 0x7540 | b)) minus 2^23 + 128, in f32."""
    b = np.arange(-128, 128, dtype=np.int64)
    bits = (0x4B000000 | ((b & 0xFF) ^ 0x80)).astype(np.uint32)
    value = bits.view(np.float32) - np.float32(8388736.0)
    assert value.dtype == np.float32 and (value == b).all()


def _k4_lane_words(buf: np.ndarray, at: int, d: int, lpr: int, r: int) -> list:
    """The words lane ``r`` of ``lpr`` picks for the row at byte ``at`` of
    ``buf``: NW = d / lpr / 4 words from the row's word c0 = r * NW, read
    as NC chunks from the row's address rounded down to 16 plus the chunk
    of word c0, then picked by selects of 4 (where reachable), 2 and 1
    words on e = phase + c0 % 4, a clamped index being one no e needs.
    Asserts that each chunk holds a byte of the row."""
    nw = d // lpr // 4
    c0, max_e = r * nw, 3 + (4 - nw if nw < 4 else 0)
    nc = (max_e + nw) // 4 + 1
    W = 4 * nc
    e, start = ((at >> 2) & 3) + c0 % 4, (at & ~15) + 16 * (c0 // 4)
    for c in range(nc):
        assert start + 16 * c < at + d + 4 and start + 16 * c + 16 > at
    w = buf[start:start + 16 * nc].view("<u4")
    t4 = [w[min(j + 4, W - 1)] if max_e >= 4 and e & 4 else w[j] for j in range(W)]
    t2 = [t4[min(j + 2, W - 1)] if e & 2 else t4[j] for j in range(W)]
    return [t2[j + 1] if e & 1 else t2[j] for j in range(nw + 1)]


@pytest.mark.parametrize("start", [0, 4, 8, 12])
@pytest.mark.parametrize("d,lpr", [(32, 1), (32, 2), (32, 4), (32, 8), (64, 1), (64, 2),
                                   (64, 4), (64, 8), (64, 16)])
def test_k4_chunks_and_selects_find_every_row_at_every_phase(d, lpr, start):
    """A (R, d + 4) table starting ``start`` bytes past a 16-byte boundary
    and ending where its 16-byte-rounded storage ends: every row (all four
    phases) and every lane's chunks stay inside the storage, and the selects
    give the lane's values and, on the row's last lane, the scale word."""
    rb, R = d + 4, 21
    buf = np.zeros(-(-(start + R * rb) // 16) * 16, np.uint8)
    table = np.random.default_rng(d + lpr + start).integers(0, 256, (R, rb), dtype=np.uint8)
    buf[start:start + R * rb] = table.reshape(-1)
    nw = d // lpr // 4
    phases = set()
    for row in range(R):
        at = start + row * rb
        phases.add((at >> 2) & 3)
        words = table[row].view("<u4")
        for r in range(lpr):
            got = _k4_lane_words(buf, at, d, lpr, r)
            assert list(got[:nw]) == list(words[r * nw:(r + 1) * nw])
            if r == lpr - 1:
                assert got[nw] == words[d // 4]
    assert phases == {0, 1, 2, 3}


def _reduce_scatter(a: np.ndarray, lpr: int, spb: int) -> np.ndarray:
    """embedding_bag_int8.cu::reduce_scatter over the 32 lanes' values
    ``a`` (32, N): strides lpr, 2 lpr, ... < lpr * spb; a lane with the
    stride's bit set keeps the upper half."""
    a = a.copy()
    h, stride = a.shape[1] // 2, lpr
    while stride < lpr * spb:
        lanes = np.arange(32)
        up = (lanes & stride) != 0
        partner = lanes ^ stride
        send = np.where(up[:, None], a[:, :h], a[:, h:2 * h])
        keep = np.where(up[:, None], a[:, h:2 * h], a[:, :h])
        a[:, :h] = keep + send[partner]
        h, stride = h // 2, stride * 2
    return a


@pytest.mark.parametrize("lpr,G,cpl", [(1, 1, 32), (2, 1, 16), (2, 1, 32), (4, 1, 16),
                                       (4, 1, 8), (8, 1, 4), (16, 1, 4), (1, 32, 32),
                                       (2, 16, 16), (4, 8, 16), (8, 4, 4)])
def test_reduce_scatter_leaves_each_lane_its_share_of_the_bag(lpr, G, cpl):
    """After the exchanges, lane (bag bi, slot s, row part r) holds the
    bag's sums of its row part's columns slot_share(s) = rev(s) * M .. + M,
    M = cpl / SPB, and the lanes of a bag cover the row once."""
    spb = 32 // lpr // G
    m = cpl // spb
    a = np.random.default_rng(cpl).integers(-1000, 1000, (32, cpl))
    out = _reduce_scatter(a, lpr, spb)
    bits = spb.bit_length() - 1
    covered = np.zeros((G, lpr, cpl), np.int64)
    for lane in range(32):
        group, r = divmod(lane, lpr)
        bi, s = divmod(group, spb)
        share = int(format(s, f"0{bits}b")[::-1], 2) * m if bits else 0
        same = [(bi * spb + t) * lpr + r for t in range(spb)]
        assert (out[lane, :m] == a[same, share:share + m].sum(axis=0)).all()
        covered[bi, r, share:share + m] += 1
    assert (covered == 1).all()


# ---------------------------------------------------------------- the models

@functools.cache
def _fresh(name: str, quant: str) -> dict:
    """The quant fixture's entries for (name, quant), rebuilt with JAX."""
    return fixture.build_model(name, quant, fixture.QUANT_WEIGHT_SEED)


@pytest.mark.parametrize("quant", fixture.QUANT_MODES)
@pytest.mark.parametrize("name", fixture.QUANT_MODELS)
def test_quant_fixture_is_current(name, quant):
    """chip_smoke.py's quant fixture equals a fresh build from the JAX package."""
    stored = np.load(fixture.QUANT_PATH)
    fresh = _fresh(name, quant)
    prefix = f"{name}/{quant}/"
    assert sorted(k for k in stored.files if k.startswith(prefix)) == \
        sorted(prefix + k for k in fresh)
    for k, v in fresh.items():
        if k.startswith("out_") or k == "fingerprint":
            np.testing.assert_allclose(stored[prefix + k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[prefix + k], v, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", fixture.QUANT_MODES)
@pytest.mark.parametrize("name", fixture.QUANT_MODELS)
def test_quant_models_match_jax_apply(name, quant, dtype):
    """Every zoo model with int8 tables on bridge.init_numpy's weights
    against JAX apply (the fixture's outputs, rebuilt)."""
    fresh = _fresh(name, quant)
    cfg = _cfg(name, dtype, table_quant=quant)
    params = bridge.params_from_numpy(bridge.init_numpy(cfg, fixture.QUANT_WEIGHT_SEED), cfg,
                                      "cpu")
    batch = Batch(fresh.get("dense"), fresh["indices"]).to("cpu")
    tag = "f32" if dtype == "float32" else "bf16"
    cases = [("", {})]
    if name == "dien":
        cases.append(("ragged_", {"seq_lengths": torch.from_numpy(fresh["seq_lengths"]),
                                  "initial_h": torch.from_numpy(fresh["initial_h"])}))
    for prefix, kw in cases:
        with torch.inference_mode():
            got = get_model(cfg, "cpu").apply(params, batch, **kw).float().numpy()
        want = fresh[f"out_{prefix}{tag}"]
        assert got.shape == want.shape == (fixture.ZOO_BATCH, cfg.out_dim)
        assert (want != 0).any()  # a relu-scored head that gives all zeros tests nothing
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=chip_smoke.bf16_atol(want))


@pytest.mark.parametrize("quant", fixture.QUANT_MODES)
@pytest.mark.parametrize("name", fixture.QUANT_MODELS)
def test_chip_smoke_quant_fixture_check_on_cpu(name, quant):
    """The comparison chip_smoke.py makes on the card, here on the CPU."""
    errs = chip_smoke.fixture_model(np.load(fixture.QUANT_PATH), name, torch.device("cpu"),
                                    table_quant=quant)
    assert set(errs) >= {"f32", "bf16"}


# ------------------------------------------------- exports, CLI and serving

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """rm1 trained 3 steps on the CPU, saved, and exported in both modes by
    the train CLI (one run a mode, each with its own float checkpoint)."""
    tmp = tmp_path_factory.mktemp("exports")
    out = {}
    for quant in ("int8", "int8_rowwise"):
        base = str(tmp / f"rm1_{quant}")
        train.main(["--model", "rm1", "--table_scale", str(SCALE), "--steps", "3",
                    "--batch_size", "16", "--lr", "0.01", "--device", "cpu", "--save", base,
                    "--export_quant", quant])
        out[quant] = base
    return out


def _standalone(extra):
    return port_main.main(["--model", "rm1", "--table_scale", str(SCALE), "--device", "cpu",
                           "--num_batches", "3", "--mini_batch_size", "16"] + extra)


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_main_serves_the_trainers_int8_export(exported, quant):
    """main.py --checkpoint <bundle> --table_quant <mode>: its scores are
    model.apply's on checkpoint_params of the bundle, bit for bit, and
    within the quantization's reach of the float checkpoint's."""
    base = exported[quant]
    res = _standalone(["--checkpoint", f"{base}_{quant}", "--table_quant", quant])
    qcfg = _cfg("rm1", table_quant=quant)
    params = checkpoint.checkpoint_params(qcfg, f"{base}_{quant}", "cpu")
    tables = params["tables"]
    assert sorted(tables) == (["q", "scale"] if quant == "int8" else ["qrows"])
    fparams = checkpoint.checkpoint_params(_cfg("rm1"), base, "cpu")
    batches = RecDataGenerator(qcfg, seed=123).generate_batches(3, 16)
    with torch.inference_mode():
        for out, b in zip(res["outputs"], batches):
            assert torch.equal(out, get_model(qcfg, "cpu").apply(params, b.to("cpu")))
            full = get_model(_cfg("rm1"), "cpu").apply(fparams, b.to("cpu"))
            assert float((out - full).abs().max()) <= chip_smoke.QUANT_SCORE_ATOL
    random = _standalone(["--table_quant", quant])["outputs"][0]
    assert not torch.equal(random, res["outputs"][0])


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_queue_and_run_serving_serve_the_int8_export(exported, quant):
    bundle = f"{exported[quant]}_{quant}"
    res = port_main.main(["--model", "rm1", "--table_scale", str(SCALE), "--queue",
                          "--engine_backend", "cpu", "--num_batches", "12",
                          "--avg_arrival_rate", "1", "--checkpoint", bundle,
                          "--table_quant", quant])
    assert res.error_responses == 0 and res.num_responses == res.cpu_sub_requests > 0
    assert not res.engine_errors
    res = run_serving(_cfg("rm1", table_quant=quant),
                      ServingConfig(engine_backend="cpu", num_batches=4,
                                    avg_arrival_rate_ms=1.0),
                      settle_s=0.0, checkpoint_path=bundle)
    assert res.error_responses == 0 and res.num_responses == res.cpu_sub_requests > 0


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_queue_serves_random_int8_tables(quant):
    """--table_quant without a checkpoint: each engine draws its int8
    tables from its seed (model.init)."""
    res = port_main.main(["--model", "dien", "--table_scale", str(SCALE), "--queue",
                          "--engine_backend", "cpu", "--num_batches", "6",
                          "--avg_arrival_rate", "1", "--table_quant", quant])
    assert res.error_responses == 0 and res.num_responses == res.cpu_sub_requests > 0
