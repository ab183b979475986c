"""K1 against its plain version on a CUDA card.

These tests need a card; without one they skip. The file imports no JAX,
so it runs where only torch is installed (``--noconftest`` skips
``tests/conftest.py``, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Tolerance (``ops.embedding.pooled_tolerance``): both versions convert rows
to the compute dtype and sum in f32, so they differ only in summation
order: |a - b| <= L * 2^-23 * sum|rows|, plus 1 bf16 ulp of the larger
value for bf16 outputs.
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch.ops import embedding_bag, embedding_bag_reference
from deeprecsys_tpu_torch.ops.embedding import pooled_tolerance

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
