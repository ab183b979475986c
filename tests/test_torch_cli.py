"""The port's standalone CLI path, on the CPU at a small size."""

import pytest
import torch

from deeprecsys_tpu_torch.main import main

ARGS = ["--model", "rm1", "--table_scale", "2000", "--num_batches", "2",
        "--mini_batch_size", "16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_standalone_prints_reference_totals(capsys, dtype):
    res = main(ARGS + ["--device", "cpu", "--param_dtype", dtype])
    out = capsys.readouterr().out
    for line in ("Total data loading time: ***", "Total computation time: ***",
                 "Total execution time: ***", "Throughput:"):
        assert line in out
    assert res["forwards"] == 3 and len(res["outputs"]) == 2
    for o in res["outputs"]:
        assert o.shape == (16, 1) and bool(torch.isfinite(o.float()).all())


@pytest.mark.parametrize("model", ["rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
def test_standalone_runs_every_family(model):
    """ncf, din and dien take no dense input (Batch.dense is None)."""
    res = main(["--model", model, "--table_scale", "2000", "--num_batches", "1",
                "--mini_batch_size", "4", "--device", "cpu"])
    assert res["forwards"] == 2 and len(res["outputs"]) == 1
    out = res["outputs"][0]
    assert out.shape[0] == 4 and bool(torch.isfinite(out).all())


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(ARGS + ["--device", "cuda"])


@pytest.mark.parametrize("flag", [["--queue"], ["--serve"], ["--checkpoint", "x"]])
def test_unported_modes_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(ARGS + ["--device", "cpu"] + flag)
