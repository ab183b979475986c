"""Parity fixtures for the PyTorch port on machines without JAX.

``torch_port_rm1.npz`` holds, for rm1 at ``table_scale=2000``:

- the f32 params of ``model.init(PRNGKey(0))``, flattened to keys
  ``tables``, ``bot/<i>/w``, ``bot/<i>/b``, ``top/<i>/w``, ``top/<i>/b``
  (the bf16 params of the same key are exactly these cast to bf16, which
  ``build`` asserts);
- one batch of 64 from ``RecDataGenerator(cfg, seed=1)``: ``dense``, ``indices``;
- the JAX package's outputs on it: ``out_f32`` and ``out_bf16`` (as f32).

``torch_port_zoo.npz`` holds, for each of the other seven zoo models at
``table_scale=2000``, keys ``<model>/...`` (no weights: they are redrawn
from the seed by ``bridge.init_numpy``, which needs only numpy):

- ``seed``: the weight seed; ``fingerprint``: the float64 sum of each f32
  leaf (``bridge.fingerprint``), so a drift of numpy's streams shows
  as a fingerprint mismatch and not as a parity failure;
- one batch of 16 from ``RecDataGenerator(cfg, seed=1)``: ``dense`` (where
  the model takes it) and ``indices``;
- the JAX outputs ``out_f32`` and ``out_bf16`` (the bf16 params are the
  f32 ones cast);
- for dien also ``seq_lengths``, ``initial_h`` and ``out_ragged_f32`` /
  ``out_ragged_bf16``: ragged histories with an initial state.

The JAX package's CPU backend cannot run a bf16 x bf16 -> f32 batched
einsum at these shapes (XLA's DotThunk rejects it), which DIN's attention
and MT-WnD's heads use; for the bf16 outputs their stacked weights are
handed to JAX as f32 arrays holding the bf16 values. The einsum then
promotes the bf16 activations to f32, and since bf16 x bf16 products are
exact in f32 and the sums run in f32 either way, the numerics are the
bf16 path's.

``chip_smoke.py`` loads both on the card; ``tests/test_torch_dlrm.py`` and
``tests/test_torch_models.py`` rebuild them and compare, so they cannot go
stale.

Regenerate: python -m tests.golden.make_torch_port_fixture [rm1] [zoo]
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from deeprecsys_tpu import zoo
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model
from deeprecsys_tpu_torch import bridge
from deeprecsys_tpu_torch import zoo as port_zoo

PATH = Path(__file__).parent / "torch_port_rm1.npz"
ZOO_PATH = Path(__file__).parent / "torch_port_zoo.npz"
ZOO_MODELS = ("rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")
SCALE = 2000
BATCH = 64
ZOO_BATCH = 16
WEIGHT_SEED = 0


def _config(dtype: str, name: str = "rm1"):
    return zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)


def _port_config(dtype: str, name: str):
    """The port's config of the same model, for the port's ``bridge``."""
    return port_zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)


def build() -> dict[str, np.ndarray]:
    cfg32, cfg16 = _config("float32"), _config("bfloat16")
    m32, m16 = get_model(cfg32), get_model(cfg16)
    p32 = jax.device_get(m32.init(jax.random.PRNGKey(0)))
    p16 = m16.init(jax.random.PRNGKey(0))
    # The bf16 init is the f32 init cast (the table also packed), so the
    # fixture needs only the f32 params.
    t16 = np.asarray(p16["tables"]["packed"]).reshape(-1, cfg16.sparse_feature_size)
    np.testing.assert_array_equal(t16[:cfg16.total_rows],
                                  p32["tables"].astype(jnp.bfloat16))
    for tower in ("bot", "top"):
        for l16, l32 in zip(p16[tower], p32[tower]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(l16[k]),
                                              l32[k].astype(jnp.bfloat16))
    batch = RecDataGenerator(cfg32, seed=1).generate_batch(BATCH)
    arrays = {"tables": p32["tables"], "dense": batch.dense, "indices": batch.indices}
    for tower in ("bot", "top"):
        for i, layer in enumerate(p32[tower]):
            for k in ("w", "b"):
                arrays[f"{tower}/{i}/{k}"] = layer[k]
    arrays["out_f32"] = np.asarray(m32.apply(p32, batch), dtype=np.float32)
    arrays["out_bf16"] = np.asarray(m16.apply(p16, batch).astype(jnp.float32))
    return {k: np.asarray(v) for k, v in arrays.items()}


def _jax_params(np_params: dict) -> dict:
    """The params as JAX takes them on the CPU: stacked MLP weights as f32
    holding their values (see the module docstring)."""
    out = dict(np_params)
    for k in ("tasks", "attention"):
        if k in out:
            out[k] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out[k])
    return out


def _ragged(batch_size: int, cfg) -> tuple[np.ndarray, np.ndarray]:
    """DIEN seq_lengths (0 and the full length among them) and an initial state."""
    rng = np.random.default_rng(2)
    T_b = cfg.num_tables - 3
    lengths = rng.integers(0, T_b + 1, size=batch_size).astype(np.int32)
    lengths[:3] = (0, 1, T_b)
    h0 = (rng.standard_normal((batch_size, cfg.hidden_size)) * 0.5).astype(np.float32)
    return lengths, h0


def build_model(name: str) -> dict[str, np.ndarray]:
    """``name``'s entries of ``torch_port_zoo.npz``, keys without the prefix."""
    arrays: dict = {"seed": np.asarray(WEIGHT_SEED)}
    cfg32 = _config("float32", name)
    batch = RecDataGenerator(cfg32, seed=1).generate_batch(ZOO_BATCH)
    if batch.dense is not None:
        arrays["dense"] = batch.dense
    arrays["indices"] = batch.indices
    arrays["fingerprint"] = bridge.fingerprint(
        bridge.init_numpy(_port_config("float32", name), WEIGHT_SEED))
    for dtype, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        cfg = _config(dtype, name)
        apply = jax.jit(get_model(cfg).apply)  # one program: faster than op by op
        params = _jax_params(bridge.init_numpy(_port_config(dtype, name), WEIGHT_SEED))
        arrays[f"out_{tag}"] = np.asarray(apply(params, batch).astype(jnp.float32))
        if name == "dien":
            lengths, h0 = _ragged(ZOO_BATCH, cfg)
            arrays["seq_lengths"], arrays["initial_h"] = lengths, h0
            arrays[f"out_ragged_{tag}"] = np.asarray(apply(
                params, batch, seq_lengths=lengths, initial_h=h0).astype(jnp.float32))
    return {k: np.asarray(v) for k, v in arrays.items()}


def build_zoo() -> dict[str, np.ndarray]:
    return {f"{name}/{k}": v for name in ZOO_MODELS for k, v in build_model(name).items()}


def main(which=("rm1", "zoo")):
    for name in which:
        path, arrays = (PATH, build()) if name == "rm1" else (ZOO_PATH, build_zoo())
        np.savez(path, **arrays)
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:] or ("rm1", "zoo"))
