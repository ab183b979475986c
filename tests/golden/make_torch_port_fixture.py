"""Parity fixture for the PyTorch port on machines without JAX.

``torch_port_rm1.npz`` holds, for rm1 at ``table_scale=2000``:

- the f32 params of ``model.init(PRNGKey(0))``, flattened to keys
  ``tables``, ``bot/<i>/w``, ``bot/<i>/b``, ``top/<i>/w``, ``top/<i>/b``
  (the bf16 params of the same key are exactly these cast to bf16, which
  ``build`` asserts);
- one batch of 64 from ``RecDataGenerator(cfg, seed=1)``: ``dense``, ``indices``;
- the JAX package's outputs on it: ``out_f32`` and ``out_bf16`` (as f32).

``chip_smoke.py`` loads it on the card; ``tests/test_torch_dlrm.py``
rebuilds it and compares, so it cannot go stale.

Regenerate: python -m tests.golden.make_torch_port_fixture
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from deeprecsys_tpu import zoo
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model

PATH = Path(__file__).parent / "torch_port_rm1.npz"
SCALE = 2000
BATCH = 64


def _config(dtype: str):
    return zoo.get_config("rm1", table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)


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


def main():
    np.savez(PATH, **build())
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
