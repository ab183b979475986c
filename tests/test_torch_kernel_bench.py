"""``kernel_bench``'s yardsticks and bounds, on the CPU: the library calls
compute the kernels' functions, and the bounds count what the docs say.

Tolerances: f32 rtol 1e-5 and atol 1e-5 (sums and dots in other orders);
the cuDNN-style RNN also adds its identity input product, exact in f32.
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.kernel_bench import (
    F32_FLOP_PER_S, HBM_BYTES_PER_S, k1_bound, k1_library, k3_bound, k3_library)
from deeprecsys_tpu_torch.models.base import table_offsets
from deeprecsys_tpu_torch.ops import embedding_bag_reference, rnn_scan_reference


@pytest.mark.parametrize("name", ["rm1", "din", "ncf"])
def test_k1_library_computes_the_pooled_lookup(name):
    cfg = zoo.get_config(name, table_scale=2000)
    g = torch.Generator().manual_seed(0)
    table = torch.randn((cfg.total_rows, cfg.sparse_feature_size), generator=g)
    offsets = table_offsets(cfg, "cpu")
    idx = torch.from_numpy(RecDataGenerator(cfg, seed=1).generate_batch(6).indices)
    got = k1_library(table, offsets)(idx).view(6, cfg.num_tables, -1)
    torch.testing.assert_close(got, embedding_bag_reference(table, offsets, idx),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", [(1, 3), (40, 6)])
def test_k3_library_computes_the_recurrence(T, B):
    g = torch.Generator().manual_seed(T)
    xproj = torch.randn((T, B, 64), generator=g)
    w = torch.randn((64, 64), generator=g) / 8
    b = torch.randn(64, generator=g) * 0.1
    got, last = k3_library(w, b)(xproj)
    want, want_last = rnn_scan_reference(xproj, w, b, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last[0], want_last, rtol=1e-5, atol=1e-5)


def test_k1_bound_counts_distinct_rows_ids_and_output():
    table = torch.zeros((100, 32), dtype=torch.bfloat16)
    offsets = torch.tensor([0, 50], dtype=torch.int32)
    idx = torch.tensor([[[1, 2, 2], [1, 3, 4]]], dtype=torch.int32)  # row 2 twice; 1 and 51
    got = k1_bound(table, offsets, idx, torch.float32)
    nbytes = 5 * 32 * 2 + 6 * 4 + 2 * 32 * 4
    assert got["bytes"] == nbytes and got["flops"] == 6 * 32
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3)


def test_k3_bound_at_dien_shape_is_its_operations():
    got = k3_bound(40, 512, 64, torch.bfloat16)
    assert got["flops"] == 2 * 40 * 512 * 64 * 64
    assert got["bytes"] == 40 * 512 * 64 * 6 + (64 * 64 + 64) * 4
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(got["flops"] / F32_FLOP_PER_S * 1e3)
    assert np.isclose(got["bound_ms"] * 1e3, 2.504, atol=1e-3)  # µs
