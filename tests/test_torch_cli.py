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


@pytest.mark.parametrize("flag", [["--queue", "--engine_backend", "sim"],
                                  ["--serve", "--engine_backend", "sim"],
                                  ["--enable_profiling"]])
def test_unported_modes_raise(flag, tmp_path, monkeypatch):
    """The three flags that raised until they were ported: the sim backend
    now raises only for want of the card's own latency ladder (none in
    ``CHAR_DIR`` here), naming the sweep that measures it, and
    --enable_profiling writes its trace (tests/test_torch_data_modes.py
    holds both further)."""
    from deeprecsys_tpu_torch.serving import latency_model

    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    argv = ARGS + ["--device", "cpu", "--profile_dir", str(tmp_path / "prof")] + flag
    if "sim" in flag:
        with pytest.raises(FileNotFoundError, match="experiments/sweep.py"):
            main(argv)
    else:
        assert main(argv)["profile_trace"].startswith(str(tmp_path / "prof"))


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serves_int8_tables(quant, dtype):
    """--table_quant standalone: int8 tables from the init, pooled by the
    int8 lookups (their plain versions on the CPU)."""
    res = main(ARGS + ["--device", "cpu", "--param_dtype", dtype, "--table_quant", quant])
    assert res["forwards"] == 3 and len(res["outputs"]) == 2
    for o in res["outputs"]:
        assert o.shape == (16, 1) and o.dtype == getattr(torch, dtype)
        assert bool(((o >= 0) & (o <= 1)).all())


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


def test_queue_cpu_mp_backend_is_not_ported(capsys):
    """cpu-mp was once refused here; it now serves --queue through an engine
    process, and prints the reference's report."""
    res = main(QUEUE + ["--engine_backend", "cpu-mp", "--inference_engines", "1"])
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["cpu_requests"] == 12 and report["error_responses"] == 0
    assert res.num_responses == res.cpu_sub_requests > 12 and not res.engine_errors


@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
@pytest.mark.parametrize("impl", ["hotcold", "auto"])
def test_queue_serves_hotcold_and_auto(impl, quant):
    """--queue --embedding_impl hotcold|auto on the CPU: every query
    answered without an error (auto at this size keeps the direct lookup:
    the table is under --hotcold_min_table_mb; with the floor at 0 it
    samples and splits)."""
    from deeprecsys_tpu_torch.ops import hotcold as hc_ops

    before = hc_ops._split_hot_cold_native.calls
    extra = ["--hotcold_min_table_mb", "0"] if quant == "int8" else []
    res = main(ARGS + ["--queue", "--engine_backend", "cpu", "--embedding_impl", impl,
                       "--table_quant", quant, "--num_batches", "6",
                       "--avg_arrival_rate", "1", "--hotcold_refresh_interval", "2"] + extra)
    assert res.error_responses == 0 and res.num_responses == res.cpu_sub_requests > 0
    split = impl == "hotcold" or quant == "int8"
    assert (hc_ops._split_hot_cold_native.calls > before) == split


def test_standalone_hotcold_raises_like_jax():
    with pytest.raises(ValueError, match="a serving-engine path"):
        main(ARGS + ["--device", "cpu", "--embedding_impl", "hotcold"])
    res = main(ARGS + ["--device", "cpu", "--embedding_impl", "auto"])
    assert res["forwards"] == 3


def test_serve_mode_sigterm_shutdown():
    """--serve answers over HTTP and exits cleanly on SIGTERM (JAX
    tests/test_cli.py::test_serve_mode_sigterm_shutdown)."""
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprecsys_tpu_torch.main", "--model", "ncf",
         "--table_scale", "2000", "--serve", "--port", "0", "--engine_backend", "cpu",
         "--max_mini_batch_size", "8", "--sub_task_batch_size", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root)
    try:
        port, lines, deadline = None, [], time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if "serving on http" in line:
                port = int(line.split(":")[2].split(" ")[0].split("/")[0])
                break
            if not line and proc.poll() is not None:
                break
        assert port, lines[-5:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["engines"] == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert "shutting down serving" in out and proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_models_registry_and_predict():
    """--serve_models puts several models behind one ingress; --device cpu
    puts the --model_accel offload engine on the CPU."""
    import urllib.request

    from deeprecsys_tpu_torch import main as port_main

    args = port_main.build_parser().parse_args(
        ["--model", "ncf", "--table_scale", "2000", "--serve", "--port", "0",
         "--serve_models", "ncf,rm1", "--engine_backend", "cpu", "--device", "cpu",
         "--model_accel", "--accel_request_size_thres", "48", "--max_mini_batch_size", "64",
         "--sub_task_batch_size", "16"])
    ing = port_main.start_serve(port_main.model_config_from_args(args), args)
    base = "http://%s:%s" % ing.address
    try:
        with urllib.request.urlopen(f"{base}/v1/models", timeout=30) as r:
            models = json.loads(r.read())
        assert set(models) == {"ncf", "rm1"} and models["rm1"]["engines"] == 2
        req = urllib.request.Request(f"{base}/v1/models/rm1/infer",
                                     data=json.dumps({"batch_size": 50}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        assert out["accel"] and out["engines"] == [1]
    finally:
        ing.stop()


@pytest.mark.parametrize("nepochs", ["1", "0"])
def test_score_output_equals_jax_cli(tmp_path, nepochs):
    """--score_output writes the last epoch's scores (f32): the JAX CLI's
    npz for the same checkpoint and batches (rtol and atol 1e-5), also with
    --nepochs 0."""
    import numpy as np

    from deeprecsys_tpu.main import main as jax_main
    from deeprecsys_tpu_torch import bridge, zoo
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    save_params(tmp_path / "ckpt", bridge.init_numpy(zoo.get_config("rm1", table_scale=2000),
                                                     99))
    argv = ["--model", "rm1", "--table_scale", "2000", "--num_batches", "3",
            "--mini_batch_size", "4", "--nepochs", nepochs, "--checkpoint",
            str(tmp_path / "ckpt")]
    res = main(argv + ["--device", "cpu", "--score_output", str(tmp_path / "port.npz")])
    assert res["forwards"] == 4  # the warm-up and three batches
    jax_main(argv + ["--score_output", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert got["scores"].dtype == np.float32 and got["scores"].shape == (12, 1)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)


def test_score_output_on_the_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(ARGS + ["--score_output", str(tmp_path / "s.npz")])
