"""The port's CLI, standalone and --queue, on the CPU at a small size."""

import json

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


@pytest.mark.parametrize("flag", [["--queue", "--engine_backend", "sim"], ["--serve"],
                                  ["--checkpoint", "x", "--table_quant", "int8_rowwise"]])
def test_unported_modes_raise(flag):
    """--queue itself is ported; its sim backend waits for the card's own
    latency ladders. --checkpoint is ported for float checkpoints; a
    quantized one waits for int8 tables (item 8)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(ARGS + ["--device", "cpu"] + flag)


QUEUE = ["--model", "rm1", "--table_scale", "2000", "--queue", "--num_batches", "12",
         "--batch_size_distribution", "normal", "--avg_mini_batch_size", "40",
         "--var_mini_batch_size", "8", "--sub_task_batch_size", "16", "--avg_arrival_rate", "1"]


def test_queue_on_the_cpu_prints_the_reference_report(capsys):
    res = main(QUEUE + ["--engine_backend", "cpu", "--inference_engines", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[-4].startswith("Measured QPS: ")
    assert out[-3].startswith("Measured p95 tail-latency: ") and out[-3].endswith(" ms")
    assert out[-2].startswith("Measured p99 tail-latency: ") and out[-2].endswith(" ms")
    report = json.loads(out[-1])
    assert report["cpu_requests"] == 12 and report["error_responses"] == 0
    assert report["num_responses"] == report["cpu_sub_requests"] == res.cpu_sub_requests
    assert res.warmup_executions == 2 * 11  # two engines, the static ladder up to 1024


def test_queue_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(QUEUE)  # --engine_backend gpu is the default


def test_queue_warns_of_several_engines_on_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(QUEUE + ["--inference_engines", "4"])
    assert "WARNING: 4 engine threads share one interpreter" in capsys.readouterr().out


def test_queue_cpu_mp_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11b"):
        main(QUEUE + ["--engine_backend", "cpu-mp"])
