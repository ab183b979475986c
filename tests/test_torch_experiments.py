"""The port's experiments against the JAX package's, on the CPU at a small
size: ``op_breakdown``'s stages, ``train_quality``'s planted data (bit for
bit) and a short planted training run, the latency ladders of ``sweep``
and the ``latency_model`` converter, ``qps_sweep``, ``scheduling_study``
and ``loadgen_study`` on the sim backend, and ``plots``."""

import json

import numpy as np
import pytest

import deeprecsys_tpu.experiments.op_breakdown as jax_op_breakdown
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.experiments import train_quality as jax_tq
from deeprecsys_tpu.serving import latency_model as jax_latency_model
from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.experiments import (
    loadgen_study, op_breakdown, plots, qps_sweep, scheduling_study, sweep, train_quality)
from deeprecsys_tpu_torch.serving import latency_model

SCALE = 2000


@pytest.mark.parametrize("name", ["rm1", "wnd", "mtwnd", "ncf", "din", "dien"])
def test_op_breakdown_stages_equal_jax(monkeypatch, name):
    """The same stages for each family; the JAX side's timing chain is
    replaced by a constant (its stage functions still run once each)."""
    monkeypatch.setattr(jax_op_breakdown, "_time_fn", lambda fn, *a, **k: 1.0)
    want = jax_op_breakdown.breakdown_for(name, 4, SCALE, "float32")
    got = op_breakdown.breakdown_for(name, 4, SCALE, "float32", device="cpu")
    assert list(got["stage_ms"]) == list(want["stage_ms"])
    assert list(got["stage_fraction"]) == list(want["stage_fraction"])
    assert all(v > 0 for v in got["stage_ms"].values())
    assert abs(sum(got["stage_fraction"].values()) - 1.0) < 1e-9
    assert got["fusion_gain"] > 0 and "kernel_device_us" not in got  # the CPU has no kernels


@pytest.mark.parametrize("name", ["rm1", "ncf", "dien"])
def test_planted_data_equals_jax_bit_for_bit(name):
    cfg, jcfg = zoo.get_config(name, table_scale=SCALE), jax_zoo.get_config(name, table_scale=SCALE)
    w = train_quality.planted_weights(cfg, seed=3)
    np.testing.assert_array_equal(w, jax_tq.planted_weights(jcfg, seed=3))
    idx = train_quality.zipf_batch(cfg, 16, np.random.default_rng(2))
    np.testing.assert_array_equal(idx, jax_tq.zipf_batch(jcfg, 16, np.random.default_rng(2)))
    tables = [1, 2] if name == "dien" else None
    for a, b in zip(train_quality.planted_labels(cfg, idx, w, np.random.default_rng(4),
                                                 signal_tables=tables),
                    jax_tq.planted_labels(jcfg, idx, w, np.random.default_rng(4),
                                          signal_tables=tables)):
        np.testing.assert_array_equal(a, b)
    got = train_quality.make_holdout(cfg, w, n_batches=2, batch=8, signal_tables=tables)
    want = jax_tq.make_holdout(jcfg, w, n_batches=2, batch=8, signal_tables=tables)
    for g, h in zip(got, want, strict=True):
        for a, b in zip(g, h, strict=True):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert train_quality.bayes_auc(got) == jax_tq.bayes_auc(want)


@pytest.fixture(scope="module")
def trained():
    """The JAX lifecycle test's run (tests/test_train_quality.py): rm1 at
    table_scale 2000, 300 steps of 128, the JAX defaults lr 0.01 and
    table_lr 1e-3."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    return train_quality.train_planted(cfg, steps=300, batch=128, eval_every=150,
                                       holdout_batches=4, log=lambda *a: None, device="cpu")


def test_sparse_trainer_learns_the_planted_signal(trained):
    """The floors of tests/test_train_quality.py: the loss falls, and the
    holdout AUC reaches 0.70 and 78% of the Bayes ceiling."""
    tr, rep = trained
    assert tr.sparse_tables and rep["lr"] == 0.01 and rep["table_lr"] == 1e-3
    assert rep["loss_last8"] < rep["loss_first8"] - 0.05, rep
    assert rep["final_auc"] >= 0.70, rep
    assert rep["final_auc"] >= 0.78 * rep["bayes_auc"], rep
    assert [p["step"] for p in rep["auc_curve"]] == [1, 150, 300]
    assert rep["steps_per_s"] > 0
    # make_holdout is seed-pure: the same holdout scores the trained model again.
    holdout = train_quality.make_holdout(tr.cfg, train_quality.planted_weights(tr.cfg),
                                         n_batches=4, batch=128)
    again = train_quality.eval_model_auc(tr.model.apply, tr.params, tr.cfg, holdout, "cpu")
    assert abs(again - rep["final_auc"]) <= 5e-5


def test_trained_models_int8_export_serves_its_auc(trained, tmp_path):
    """The JAX lifecycle test's second half (tests/test_train_quality.py:44-68)
    on the same trained model: its int8 row-wise export
    (``export_serving_params``) checkpointed (``save_params``), served by
    ``ServingServer`` on one CPU engine with buckets (128,), scores the
    holdout within 0.02 AUC of the trained model, as the JAX test holds it
    (the export's 7-bit rounding and the serving path lie in between)."""
    from deeprecsys_tpu_torch import ServingConfig, bridge
    from deeprecsys_tpu_torch.serving.ingress import ServingServer
    from deeprecsys_tpu_torch.train import export_serving_params
    from deeprecsys_tpu_torch.utils.checkpoint import save_params
    from deeprecsys_tpu_torch.utils.metrics_ml import auc

    tr, rep = trained
    sp, qcfg = export_serving_params(tr.params, tr.cfg)
    assert qcfg.table_quant == "int8_rowwise" and set(sp["tables"]) == {"qrows"}
    save_params(tmp_path / "ck", bridge.params_to_numpy(sp, qcfg))
    holdout = train_quality.make_holdout(tr.cfg, train_quality.planted_weights(tr.cfg),
                                         n_batches=4, batch=128)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, batch_buckets=(128,),
                         max_mini_batch_size=128, sub_task_batch_size=128)
    server = ServingServer(qcfg, scfg, checkpoint_path=str(tmp_path / "ck"),
                           accel_device="cpu")
    server.start(timeout=600)
    try:
        scores, labels = [], []
        for idx, dense, _logits, y in holdout:
            out = server.predict(idx, dense=dense, timeout=120)
            scores.append(np.asarray(out["scores"], np.float32)[:, 0])
            labels.append(y)
    finally:
        server.stop()
    served = auc(np.concatenate(scores), np.concatenate(labels).astype(int))
    assert abs(served - rep["final_auc"]) <= 0.02, (served, rep["final_auc"])


def test_sweep_writes_a_cpu_ladder_the_sim_never_reads(tmp_path, monkeypatch):
    rows = sweep.main(["--models", "ncf", "--batches", "1", "4", "16", "--table-scale",
                       str(SCALE), "--dtype", "float32", "--device", "cpu",
                       "--out-dir", str(tmp_path)])
    ladder = json.loads((tmp_path / "cpu_ncf.json").read_text())
    assert ladder["batch_sizes"] == [1, 4, 16] and ladder["device"] == "cpu"
    assert ladder["power_limit"] is None and ladder["table_scale"] == SCALE
    assert set(ladder) == {"batch_sizes", "latencies_ms", "base", "table_scale", "dtype",
                           "table_pack", "device", "power_limit"}
    assert all(ms > 0 for ms in ladder["latencies_ms"])
    assert rows[0]["latencies_ms"] == ladder["latencies_ms"]
    lm = latency_model.LatencyModel.load(tmp_path / "cpu_ncf.json")
    assert lm.predict_ms(4) == ladder["latencies_ms"][1]
    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    with pytest.raises(FileNotFoundError, match="gpu_ncf.json"):
        latency_model.load_card_ladder("ncf")


def test_latency_model_cli_equals_jax(tmp_path, capsys):
    raw = tmp_path / "results.txt"
    raw.write_text("".join(f"x *** {v} ms\n" for v in (1, 2, 3, 4, 5, 6.5, 1, 2, 3, 4, 5, 9.0)))
    latency_model.main(["--from-raw", str(raw), "--out", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    jax_latency_model.main(["--from-raw", str(raw), "--out", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert port_out.replace("port.json", "x") == capsys.readouterr().out.replace("jax.json", "x")


def _card_ladder(tmp_path, monkeypatch, name="rm1"):
    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    (tmp_path / f"gpu_{name}.json").write_text(json.dumps(
        {"batch_sizes": [1, 4, 16, 64, 256, 1024], "latencies_ms": [0.3, 0.3, 0.35, 0.5, 1.2, 4.0],
         "base": 4.0, "device": "a test ladder", "power_limit": None}))


@pytest.fixture
def qps_result(tmp_path, monkeypatch):
    _card_ladder(tmp_path, monkeypatch)
    return qps_sweep.main(["--model", "rm1", "--backend", "calibrated-sim", "--table-scale",
                           str(SCALE), "--num-batches", "16", "--min-arr", "0.5",
                           "--max-arr", "4", "--steps", "3",
                           "--out", str(tmp_path / "qps_sweep.json")])


def test_qps_sweep_on_the_card_ladder(qps_result, tmp_path):
    rows = qps_result["sweep"]
    assert [r["arrival_ms"] for r in rows] == pytest.approx([0.5, 2 ** 0.5, 4.0])
    ok = [r["qps"] for r in rows if r["meets_sla"]]
    assert qps_result["latency_bounded_qps"] == (max(ok) if ok else 0.0)
    assert all(np.isfinite(r["p95_ms"]) for r in rows)
    assert json.loads((tmp_path / "qps_sweep.json").read_text())["rm1:calibrated-sim"] == \
        qps_result


@pytest.mark.parametrize("files", [[], ["tpu_rm1.json", "cpu_rm1.json"]])
def test_qps_sweep_refuses_other_ladders(tmp_path, monkeypatch, files):
    monkeypatch.setattr(latency_model, "CHAR_DIR", tmp_path)
    for f in files:
        (tmp_path / f).write_text(json.dumps({"batch_sizes": [1], "latencies_ms": [1.0]}))
    with pytest.raises(FileNotFoundError, match="experiments/sweep.py"):
        qps_sweep.sweep("rm1", "calibrated-sim", 25.0, [5.0], 1, 8, SCALE, 64)
    with pytest.raises(ValueError, match="unknown backend"):
        qps_sweep.sweep("rm1", "sim", 25.0, [5.0], 1, 8, SCALE, 64)


def test_qps_sweep_on_cpu_engines():
    r = qps_sweep.sweep("ncf", "cpu", 25.0, [4.0], 1, 8, SCALE, 64)
    assert len(r["sweep"]) == 1 and r["sweep"][0]["qps"] > 0


@pytest.mark.parametrize("tune_accel", [False, True])
def test_scheduling_study_on_sim(tune_accel):
    rows = scheduling_study.run_study("ncf", seeds=1, tune_accel=tune_accel, backend="sim",
                                      table_scale=SCALE, quick=True)
    assert len(rows) == 1 and rows[0]["optimal_sub_batch"] in (512, 256, 128, 64, 32)
    assert (rows[0]["optimal_accel_thres"] is not None) == tune_accel


def test_scheduling_study_cli_merges_its_rows(tmp_path):
    out = tmp_path / "s.json"
    out.write_text(json.dumps([{"ref_regime": True, "model": "wnd", "seed": 9}]))
    scheduling_study.main(["--seeds", "1", "--table-scale", str(SCALE), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert rows[0] == {"ref_regime": True, "model": "wnd", "seed": 9}
    assert [(r["model"], r["tune_accel"]) for r in rows[1:]] == [("ncf", False), ("ncf", True)]


def test_loadgen_study_on_sim(tmp_path):
    out = tmp_path / "lg.json"
    loadgen_study.main(["--num-batches", "24", "--table-scale", str(SCALE), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r["dist"] for r in rows] == ["normal", "lognormal"]
    assert all(np.isfinite(r["p95_ms"]) for r in rows)


def test_plots_render_from_the_outputs(tmp_path, trained, qps_result, capsys):
    """Every figure from the experiments' JSON outputs; the speedup figure
    from a card's and a host's ladder, the zipf figure from skew_bench's
    JSON layout."""
    bench = tmp_path / "bench"
    bench.mkdir()
    rows = [op_breakdown.breakdown_for(m, b, SCALE, "float32", device="cpu")
            for m in ("rm1", "dien") for b in (1, 4)]
    (bench / "op_breakdown.json").write_text(json.dumps(rows))
    (bench / "qps_sweep.json").write_text((tmp_path / "qps_sweep.json").read_text())
    (bench / "train_quality.json").write_text(json.dumps({"rm1": trained[1]}))
    (bench / "skew.json").write_text(json.dumps({"card": "a test card", "models": [
        {"model": "rm1", "alpha": 1.2, "batch": 512, "xla_ms": 0.52, "hotcold_ms": 0.6,
         "speedup": 0.8, "hot_coverage": 0.83, "auto_impl": "hotcold"}]}))
    char = tmp_path / "char"
    char.mkdir()
    for prefix, ms in (("gpu", [0.2, 0.3]), ("cpu", [1.0, 9.0])):
        (char / f"{prefix}_rm1.json").write_text(json.dumps(
            {"batch_sizes": [1, 512], "latencies_ms": ms}))
    plots.main(["--bench-dir", str(bench), "--char-dir", str(char)])
    for f in ("op_breakdown", "qps_sla", "train_quality", "model_speedup", "zipf_bench"):
        assert (bench / "png" / f"{f}.png").stat().st_size > 10_000, f
    empty = tmp_path / "empty"
    plots.main(["--bench-dir", str(empty), "--char-dir", str(empty)])
    assert capsys.readouterr().out.count("skip ") == 5
