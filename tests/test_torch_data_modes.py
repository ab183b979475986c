"""The port's synthetic and dataset modes against the JAX package's, on the
CPU at ``table_scale=2000``: the generators' batches and targets equal bit
for bit (the native LRU stream and the numpy one), the hot-set sampler in
synthetic mode, the Criteo DLRM's forward on dataset batches (f32 rtol
1e-5, ``bridge`` weights), and ``main.py`` standalone in both modes against
the JAX CLI's scores, ``--queue`` in both modes, ``--engine_backend sim``
over a ladder in ``tmp_path`` and ``--enable_profiling``."""

import json

import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu.data.criteo import criteo_model_config as jax_criteo_config
from deeprecsys_tpu.main import main as jax_main
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.hotcold import (
    hot_ids_and_coverage_from_generator as jax_hot_ids_and_coverage)
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.data import RecDataGenerator, trace
from deeprecsys_tpu_torch.data.criteo import criteo_model_config, write_synthetic_criteo
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.hotcold import hot_ids_and_coverage_from_generator
from deeprecsys_tpu_torch.runtime.native import native_available
from deeprecsys_tpu_torch.serving import latency_model
from deeprecsys_tpu_torch.utils.checkpoint import save_params

SCALE = 2000
CRITEO_ROWS = 320  # five batches of 64; more than the hot-set sampler's 256


@pytest.fixture(scope="module")
def dists(tmp_path_factory):
    """A 3-line and a 2-line distribution file, and per-table 2-line files
    named by the ``@`` placeholder (a different distribution a table)."""
    d = tmp_path_factory.mktemp("dists")
    la, vals, cdf = trace.synthesize_zipf_distribution(400, num_samples=4000, seed=1)
    trace.write_dist_file(d / "three.txt", la, vals, cdf)
    trace.write_dist_file_2line(d / "two.txt", vals, cdf)
    for t in range(8):
        _, v, c = trace.synthesize_zipf_distribution(300 + 40 * t, num_samples=3000, seed=t)
        trace.write_dist_file_2line(d / f"table{t}.txt", v, c)
    return {"three": str(d / "three.txt"), "two": str(d / "two.txt"),
            "per_table": str(d / "table@.txt")}


@pytest.fixture(scope="module")
def criteo_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("criteo") / "train.txt"
    write_synthetic_criteo(p, num_rows=CRITEO_ROWS, seed=3)
    return str(p)


@pytest.fixture(params=["native", "numpy"])
def impl(request, monkeypatch):
    """Both packages' synthetic streams through the native LRU, or both
    through the numpy loop."""
    if request.param == "native":
        if not native_available():
            pytest.skip("the native runtime does not build here")
    else:
        import deeprecsys_tpu.runtime.native as jax_native
        import deeprecsys_tpu_torch.runtime.native as port_native

        monkeypatch.setattr(jax_native, "native_available", lambda: False)
        monkeypatch.setattr(port_native, "native_available", lambda: False)
    return request.param


def _assert_batches_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.indices.dtype == np.int32
        np.testing.assert_array_equal(g.indices, w.indices)
        if w.dense is None:
            assert g.dense is None
        else:
            np.testing.assert_array_equal(g.dense, w.dense)


# The per-table files cover rm1's eight tables; ncf draws L = 1.
@pytest.mark.parametrize("name,dist", [("rm1", "three"), ("rm1", "two"), ("rm1", "per_table"),
                                       ("ncf", "three"), ("ncf", "two")])
def test_synthetic_batches_equal_jax(impl, dists, name, dist):
    kw = dict(seed=5, data_generation="synthetic", trace_file=dists[dist])
    want = JaxGenerator(jax_zoo.get_config(name, table_scale=SCALE), **kw)
    got = RecDataGenerator(zoo.get_config(name, table_scale=SCALE), **kw)
    for batch in (4, 9, 1):  # the state carries across batches of any size
        _assert_batches_equal(got.generate_batches(1, batch), want.generate_batches(1, batch))
    np.testing.assert_array_equal(got.generate_targets(6, round_targets=True),
                                  want.generate_targets(6, round_targets=True))


def test_synthetic_ids_are_sorted_unique_groups_in_range(dists):
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    idx = RecDataGenerator(cfg, data_generation="synthetic",
                           trace_file=dists["two"]).generate_batch(6).indices
    assert (np.diff(idx, axis=-1) > 0).all()
    assert idx.min() >= 0 and (idx < np.asarray(cfg.scaled_rows)[None, :, None]).all()


def test_degenerate_trace_raises_as_jax(tmp_path, impl):
    """A trace with fewer distinct lines than L cannot fill a group."""
    p = tmp_path / "tiny.txt"
    trace.write_dist_file(p, [0, 1, 2], [0, 1, 2], [0.3, 0.6, 1.0])
    errors = []
    for gen_cls, z in ((RecDataGenerator, zoo), (JaxGenerator, jax_zoo)):
        gen = gen_cls(z.get_config("rm1", table_scale=SCALE), data_generation="synthetic",
                      trace_file=str(p))
        with pytest.raises(ValueError, match="distinct ids") as e:
            gen.generate_batch(2)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_a_pdf_file_is_refused(tmp_path):
    p = tmp_path / "sd_prob"
    trace.write_dist_file_2line(p, [0, 1, 2], [0.5, 0.3, 0.2])
    gen = RecDataGenerator(zoo.get_config("ncf", table_scale=SCALE),
                           data_generation="synthetic", trace_file=str(p))
    with pytest.raises(ValueError, match="not a CDF"):
        gen.generate_batch(1)


def _criteo_cfgs(rows=1000):
    return criteo_model_config(rows_per_table=rows), jax_criteo_config(rows_per_table=rows)


@pytest.mark.parametrize("batch", [64, 50])
def test_dataset_batches_and_targets_equal_jax_through_eof(criteo_file, batch):
    """Four passes over a file of five batches: the stream cycles at EOF
    (a 50-row batch drops the file's 20-row tail, as JAX's does), and each
    batch's targets are the file's labels."""
    cfg, jcfg = _criteo_cfgs()
    got = RecDataGenerator(cfg, data_generation="dataset", raw_data_file=criteo_file)
    want = JaxGenerator(jcfg, data_generation="dataset", raw_data_file=criteo_file)
    first = None
    for i in range(4 * (CRITEO_ROWS // batch)):
        g, w = got.generate_batch(batch), want.generate_batch(batch)
        _assert_batches_equal([g], [w])
        np.testing.assert_array_equal(got.generate_targets(batch), want.generate_targets(batch))
        assert got.generate_targets(batch).shape == (batch, 1)
        if i == 0:
            first = g
    np.testing.assert_array_equal(got.generate_batch(batch).indices, first.indices)  # cycled


def test_dataset_errors_equal_jax(criteo_file):
    cfg, jcfg = _criteo_cfgs()
    for gen_cls, c in ((RecDataGenerator, cfg), (JaxGenerator, jcfg)):
        gen = gen_cls(c, data_generation="dataset", raw_data_file=criteo_file)
        with pytest.raises(ValueError, match="call it first"):
            gen.generate_targets(4)
        with pytest.raises(ValueError, match="fewer than 400 rows"):
            gen.generate_batch(400)
        gen.generate_batch(16)
        with pytest.raises(ValueError, match="call it first"):
            gen.generate_targets(17)
        with pytest.raises(ValueError, match="26 tables"):
            gen_cls(c.replace(embedding_rows=(10,) * 3), data_generation="dataset",
                    raw_data_file=criteo_file)


@pytest.mark.parametrize("mode", ["synthetic", "dataset"])
def test_hot_ids_and_coverage_from_the_stream_equal_jax(dists, criteo_file, mode):
    if mode == "synthetic":
        cfg, jcfg = zoo.get_config("rm1", table_scale=SCALE), \
            jax_zoo.get_config("rm1", table_scale=SCALE)
    else:
        cfg, jcfg = _criteo_cfgs()
    kw = dict(seed=31, hot_rows=256, n_batches=4, batch_size=32, data_generation=mode,
              trace_file=dists["two"], raw_data_file=criteo_file)
    got, got_cov = hot_ids_and_coverage_from_generator(cfg, **kw)
    want, want_cov = jax_hot_ids_and_coverage(jcfg, **kw)
    np.testing.assert_array_equal(got, want)
    assert got_cov == want_cov and 0.0 < got_cov <= 1.0


def test_criteo_forward_on_dataset_batches_matches_jax(criteo_file):
    """The Criteo DLRM (26 tables at L = 1, the dot interaction) on the
    file's batches, through the same numpy weights: f32 rtol 1e-5."""
    cfg, jcfg = _criteo_cfgs()
    np_params = bridge.init_numpy(cfg, 4)
    jax_model, port_model = jax_get_model(jcfg), get_model(cfg, "cpu")
    params = bridge.params_from_numpy(np_params, cfg, "cpu")
    gen = RecDataGenerator(cfg, data_generation="dataset", raw_data_file=criteo_file)
    for _ in range(3):
        b = gen.generate_batch(64)
        want = np.asarray(jax_model.apply(np_params, b))
        with torch.inference_mode():
            got = port_model.apply(params, b.to("cpu")).numpy()
        assert got.shape == (64, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _cli_argv(mode, dists, criteo_file):
    if mode == "dataset":
        return ["--model", "criteo", "--table_scale", "1000", "--data_generation", "dataset",
                "--raw_data_file", criteo_file, "--num_batches", str(CRITEO_ROWS // 64),
                "--mini_batch_size", "64"]
    return ["--model", "rm1", "--table_scale", str(SCALE), "--data_generation", "synthetic",
            "--synthetic_data_trace_file", dists["two"], "--num_batches", "2",
            "--mini_batch_size", "8"]


@pytest.mark.parametrize("mode", ["dataset", "synthetic"])
def test_standalone_scores_equal_jax_cli(tmp_path, dists, criteo_file, mode):
    """``--score_output`` in each mode: the JAX CLI's scores for the same
    checkpoint (f32 rtol and atol 1e-5); in dataset mode one score a row of
    the file, in its order."""
    argv = _cli_argv(mode, dists, criteo_file)
    cfg = port_main.model_config_from_args(port_main.build_parser().parse_args(argv))
    save_params(tmp_path / "ckpt", bridge.init_numpy(cfg, 7))
    argv += ["--checkpoint", str(tmp_path / "ckpt")]
    res = port_main.main(argv + ["--device", "cpu", "--score_output", str(tmp_path / "p.npz")])
    assert res["profile_trace"] is None
    jax_main(argv + ["--score_output", str(tmp_path / "j.npz")])
    with np.load(tmp_path / "p.npz") as got, np.load(tmp_path / "j.npz") as want:
        assert got["scores"].shape == want["scores"].shape
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
        if mode == "dataset":
            assert got["scores"].shape == (CRITEO_ROWS, 1)
            assert np.isfinite(got["scores"]).all()


@pytest.mark.parametrize("mode", ["dataset", "synthetic"])
def test_queue_serves_each_mode(capsys, dists, criteo_file, mode):
    """The engines pre-generate their bucket rows (the largest bucket's, 64
    here: the file holds 320) and sample the hot set from the mode's
    stream."""
    argv = _cli_argv(mode, dists, criteo_file)[:-4] + [
        "--queue", "--engine_backend", "cpu", "--num_batches", "6",
        "--batch_size_distribution", "normal", "--avg_mini_batch_size", "20",
        "--var_mini_batch_size", "4", "--max_mini_batch_size", "64",
        "--sub_task_batch_size", "16", "--avg_arrival_rate", "1", "--embedding_impl", "hotcold",
        "--hot_set_rows", "64"]
    res = port_main.main(argv)
    assert res.cpu_requests == 6 and res.error_responses == 0 and not res.engine_errors
    assert "Measured p95 tail-latency" in capsys.readouterr().out


def _ladder(dir_, name, prefix="gpu"):
    (dir_ / f"{prefix}_{name}.json").write_text(json.dumps({
        "batch_sizes": [1, 4, 16, 64, 256, 1024],
        "latencies_ms": [0.4, 0.4, 0.45, 0.5, 0.8, 1.6], "base": 4.0,
        "table_scale": SCALE, "dtype": "bfloat16", "table_pack": 0,
        "device": "a test ladder", "power_limit": None}))


SIM = ["--model", "rm1", "--table_scale", str(SCALE), "--queue", "--engine_backend", "sim",
       "--num_batches", "24", "--batch_size_distribution", "normal",
       "--avg_mini_batch_size", "165", "--var_mini_batch_size", "16",
       "--sub_task_batch_size", "32", "--avg_arrival_rate", "2"]


@pytest.mark.parametrize("accel", [False, True])
def test_sim_backend_runs_on_the_card_ladder(tmp_path, monkeypatch, capsys, accel):
    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    _ladder(tmp_path, "rm1")
    extra = ["--model_accel", "--accel_request_size_thres", "175"] if accel else []
    res = port_main.main(SIM + extra)
    assert res.cpu_requests + res.accel_requests == 24 and res.error_responses == 0
    assert (res.accel_requests > 0) == accel
    assert res.executions == 0  # no model ran: every engine slept
    assert "a test ladder" in capsys.readouterr().out


@pytest.mark.parametrize("other", [["tpu"], ["cpu"], ["tpu", "cpu"]])
def test_sim_backend_refuses_other_machines_ladders(tmp_path, monkeypatch, other):
    """Only ``gpu_<model>.json`` calibrates a sim engine: the JAX package's
    ``tpu_*``/``cpu_*`` ladders never stand in."""
    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    for prefix in other:
        _ladder(tmp_path, "rm1", prefix)
    with pytest.raises(FileNotFoundError, match="experiments/sweep.py"):
        port_main.main(SIM)
    with pytest.raises(FileNotFoundError, match="gpu_rm1.json"):
        port_main.main(SIM[:4] + ["--serve", "--engine_backend", "sim", "--port", "0"])


def test_enable_profiling_writes_a_trace(tmp_path, capsys):
    res = port_main.main(["--model", "rm1", "--table_scale", str(SCALE), "--num_batches", "2",
                          "--mini_batch_size", "8", "--device", "cpu", "--enable_profiling",
                          "--profile_dir", str(tmp_path / "prof")])
    trace_file = res["profile_trace"]
    assert trace_file.startswith(str(tmp_path / "prof")) and trace_file.endswith(".json")
    events = json.loads(open(trace_file).read())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert "Self CPU" in capsys.readouterr().out
    assert res["forwards"] == 3


def test_queue_profiling_writes_a_trace(tmp_path):
    port_main.main(["--model", "rm1", "--table_scale", str(SCALE), "--queue",
                    "--engine_backend", "cpu", "--num_batches", "4", "--avg_mini_batch_size",
                    "16", "--sub_task_batch_size", "16", "--avg_arrival_rate", "1",
                    "--enable_profiling", "--profile_dir", str(tmp_path)])
    assert len(list(tmp_path.glob("rm1_queue_*.pt.trace.json"))) == 1


def test_serve_on_sim_engines_over_the_card_ladders(tmp_path, monkeypatch):
    """``--serve --engine_backend sim``: each model of ``--serve_models``
    sleeps over its own ladder, the offload engine too."""
    import urllib.request

    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    for name in ("ncf", "rm1"):
        _ladder(tmp_path, name)
    args = port_main.build_parser().parse_args(
        ["--model", "ncf", "--table_scale", str(SCALE), "--serve", "--port", "0",
         "--serve_models", "ncf,rm1", "--engine_backend", "sim", "--model_accel",
         "--accel_request_size_thres", "48", "--max_mini_batch_size", "64",
         "--sub_task_batch_size", "16"])
    ing = port_main.start_serve(port_main.model_config_from_args(args), args)
    base = "http://%s:%s" % ing.address
    try:
        for name, rows in (("ncf", 20), ("rm1", 50)):
            req = urllib.request.Request(f"{base}/v1/models/{name}/infer",
                                         data=json.dumps({"batch_size": rows}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                out = json.loads(r.read())
            assert out["accel"] == (rows >= 48), out
    finally:
        ing.stop()
