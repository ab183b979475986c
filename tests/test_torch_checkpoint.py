"""Checkpoints, serving exports, the train CLI and ``main.py --checkpoint``
of the port against the JAX package, on the CPU.

- The checkpoint format (``utils/checkpoint.py``) is the contract between
  the packages: the treedef strings and leaf shapes equal JAX's for all
  eight zoo models in every table layout; a checkpoint written by either
  package loads in the other, leaf for leaf and bit for bit.
- ``export_serving_params`` equals JAX's byte for byte (``qrows``,
  ``q_packed`` and ``scale``): both quantize in the same f32 (or table
  dtype) operations with round-half-to-even.
- The train CLI runs on synthetic data and on a written Criteo TSV, saves
  and exports; ``main.py --checkpoint`` (standalone and ``--queue``) and
  ``run_serving(checkpoint_path=...)`` score what the trained params score
  (f32 rtol 1e-6: the same tensors through the same forward), and an int8
  export bundle serves with ``--table_quant``.
"""

import re

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import criteo as jax_criteo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.utils import checkpoint as jax_checkpoint
from deeprecsys_tpu_torch import ServingConfig, bridge, train, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.serving import orchestrator, run_serving
from deeprecsys_tpu_torch.utils import checkpoint

SCALE = 2000
LAYOUTS = {"f32": dict(), "bf16": dict(param_dtype="bfloat16", compute_dtype="bfloat16"),
           "int8": dict(table_quant="int8"), "int8_rowwise": dict(table_quant="int8_rowwise")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", jax_zoo.MODEL_NAMES)
def test_treedef_and_shapes_equal_jax(name, layout):
    kw = dict(table_scale=SCALE, **LAYOUTS[layout])
    jcfg = jax_zoo.get_config(name, **kw)
    template = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    shapes = bridge.param_shapes(zoo.get_config(name, **kw))
    assert checkpoint.treedef_str(shapes) == str(jax.tree_util.tree_structure(template))
    want = jax.tree_util.tree_leaves(template)
    got = checkpoint.tree_flatten(shapes)
    assert [(tuple(g.shape), np.dtype(checkpoint._np_dtype(g.dtype))) for g in got] == [
        (tuple(w.shape), np.dtype(w.dtype)) for w in want]


def test_treedef_str_formats_like_jax():
    tree = {"b": [{"w": 1, "b": 2}, 3], "a": {"x": {}}, "c": (4,), "d": (5, 6), "e": [],
            "f": None, "g'q": 7}
    assert checkpoint.treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    assert checkpoint.tree_flatten(tree) == jax.tree_util.tree_leaves(tree)


def _trained(name="rm1", steps=2, **kw):
    tr = train.Trainer(zoo.get_config(name, table_scale=SCALE, **kw), learning_rate=0.1,
                       device="cpu")
    tr.fit(steps, batch_size=16)
    return tr


def _assert_trees_equal(got, want):
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", ["rm1", "mtwnd", "dien"])
def test_port_checkpoint_loads_in_jax_and_back(name, tmp_path):
    tr = _trained(name)
    tree = bridge.params_to_numpy(tr.params, tr.cfg)
    checkpoint.save_params(tmp_path / "ckpt", tree)
    jcfg = jax_zoo.get_config(name, table_scale=SCALE)
    _assert_trees_equal(jax_checkpoint.load_model_params(jcfg, tmp_path / "ckpt"), tree)
    _assert_trees_equal(checkpoint.load_model_params(tr.cfg, tmp_path / "ckpt"), tree)
    served = checkpoint.checkpoint_params(tr.cfg, tmp_path / "ckpt", "cpu")
    for k, v in bridge.flatten(tr.params).items():
        assert torch.equal(bridge.flatten(served)[k], v), k


@pytest.mark.parametrize("name,dtype", [("rm1", "float32"), ("din", "float32"),
                                        ("ncf", "bfloat16"), ("dien", "bfloat16")])
def test_jax_checkpoint_loads_in_the_port(name, dtype, tmp_path):
    """bf16 configs resolve to packed tables, and their leaves are stored
    as 2-byte voids, which the port reads back by their bit patterns (the
    JAX package's own loader refuses them)."""
    jcfg = jax_zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)
    params = jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(3)))
    jax_checkpoint.save_params(tmp_path / "j", params)
    cfg = zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)
    _assert_trees_equal(checkpoint.load_model_params(cfg, tmp_path / "j"), params)
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="cast"):
            jax_checkpoint.load_model_params(jcfg, tmp_path / "j")


def test_dotted_names_and_missing_checkpoints(tmp_path):
    tr = _trained(steps=1)
    a = bridge.params_to_numpy(tr.params, tr.cfg)
    b = bridge.tree_map(lambda x: x + np.float32(1), a)
    checkpoint.save_params(tmp_path / "ckpt.v1", a)
    checkpoint.save_params(tmp_path / "ckpt.v2", b)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt.v1.npz", "ckpt.v1.tree.json", "ckpt.v2.npz", "ckpt.v2.tree.json"]
    _assert_trees_equal(checkpoint.load_model_params(tr.cfg, tmp_path / "ckpt.v1"), a)
    _assert_trees_equal(checkpoint.load_model_params(tr.cfg, tmp_path / "ckpt.v2"), b)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        checkpoint.load_model_params(tr.cfg, tmp_path / "ckpt")
    # A file under the collapsed name of another dotted name is not a fallback.
    checkpoint.save_params(tmp_path / "old", a)
    (tmp_path / "old.npz").rename(tmp_path / "ckpt.npz")
    with pytest.raises(FileNotFoundError, match="collapsed a dotted name"):
        checkpoint.load_model_params(tr.cfg, tmp_path / "ckpt.v3")


def test_wrong_structures_are_rejected(tmp_path):
    tr = _trained(steps=1)
    checkpoint.save_params(tmp_path / "rm1", bridge.params_to_numpy(tr.params, tr.cfg))
    with pytest.raises(ValueError, match="tree structure does not match"):
        checkpoint.load_model_params(zoo.get_config("wnd", table_scale=SCALE), tmp_path / "rm1")
    with pytest.raises(ValueError, match="leaf shape mismatch"):
        checkpoint.load_model_params(zoo.get_config("rm1", table_scale=1000), tmp_path / "rm1")
    (tmp_path / "rm1.tree.json").unlink()  # no sidecar: the leaf count still decides
    with pytest.raises(ValueError, match="leaves, expected"):
        checkpoint.load_model_params(zoo.get_config("wnd", table_scale=SCALE), tmp_path / "rm1")


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
@pytest.mark.parametrize("name,dtype", [("rm1", "float32"), ("wnd", "float32"),
                                        ("dien", "float32"), ("rm3", "bfloat16")])
def test_export_equals_jax_byte_for_byte(name, dtype, quant, tmp_path):
    tr = _trained(name, param_dtype=dtype, compute_dtype=dtype)
    # The JAX export takes the logical (R, d) table (a packed one raises).
    tree = dict(bridge.params_to_numpy(tr.params, tr.cfg),
                tables=bridge._to_numpy(tr.params["tables"]))
    jcfg = jax_zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)
    want, want_cfg = jax_train.export_serving_params(tree, jcfg, table_quant=quant)
    sp, scfg = train.export_serving_params(tr.params, tr.cfg, table_quant=quant)
    assert scfg.table_quant == quant and scfg.resolved_table_pack == want_cfg.resolved_table_pack
    got = bridge.params_to_numpy(sp, scfg)
    _assert_trees_equal(got, jax.device_get(want))
    # The bundle crosses both ways as a file.
    checkpoint.save_params(tmp_path / "q", got)
    if dtype == "float32":
        _assert_trees_equal(jax_checkpoint.load_model_params(want_cfg, tmp_path / "q"), got)
    else:  # the bf16 MLP leaves: the JAX loader cannot cast them (module docstring)
        with pytest.raises(ValueError, match="cast"):
            jax_checkpoint.load_model_params(want_cfg, tmp_path / "q")
    jax_checkpoint.save_params(tmp_path / "jq", want)
    loaded = checkpoint.load_model_params(scfg, tmp_path / "jq")
    _assert_trees_equal(loaded, got)
    back = bridge.params_from_numpy(loaded, scfg, "cpu")["tables"]
    for k, v in sp["tables"].items():
        assert torch.equal(back[k], v), k


def test_export_rejects_quantized_and_unknown():
    tr = _trained(steps=1)
    sp, _ = train.export_serving_params(tr.params, tr.cfg)
    with pytest.raises(ValueError, match="already quantized"):
        train.export_serving_params(sp, tr.cfg)
    with pytest.raises(ValueError, match="unknown table_quant"):
        train.export_serving_params(tr.params, tr.cfg, table_quant="int4")


def _jax_line_pattern(line: str) -> str:
    return re.sub(r"\d+\.\d+", "<x>", line)


def test_train_cli_synthetic_save_and_export(tmp_path, capsys):
    args = ["--model", "dien", "--table_scale", str(SCALE), "--steps", "5",
            "--batch_size", "16", "--sparse_tables", "--eval_every", "5"]
    losses = train.main(args + ["--device", "cpu", "--save", str(tmp_path / "p"),
                                "--export_quant", "int8"])
    out = capsys.readouterr().out.splitlines()
    jax_train.main(args + ["--save", str(tmp_path / "j"), "--export_quant", "int8"])
    jout = capsys.readouterr().out.splitlines()
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert [_jax_line_pattern(x) for x in out] == [
        _jax_line_pattern(x).replace(str(tmp_path / "j"), str(tmp_path / "p")) for x in jout]
    cfg = zoo.get_config("dien", table_scale=SCALE, output_head="logits")
    jcfg = jax_zoo.get_config("dien", table_scale=SCALE, output_head="logits")
    jax_checkpoint.load_model_params(jcfg, tmp_path / "p")
    jax_checkpoint.load_model_params(jcfg.replace(table_quant="int8"), tmp_path / "p_int8")
    checkpoint.load_model_params(cfg.replace(table_quant="int8"), tmp_path / "j_int8")


def test_train_cli_criteo(tmp_path, capsys):
    tsv, held = tmp_path / "train.tsv", tmp_path / "eval.tsv"
    jax_criteo.write_synthetic_criteo(tsv, 160, seed=1, signal=True)
    jax_criteo.write_synthetic_criteo(held, 64, seed=2, signal=True)
    losses = train.main(["--criteo", str(tsv), "--criteo_rows_per_table", "300",
                         "--batch_size", "32", "--steps", "4", "--epochs", "2",
                         "--criteo_eval", str(held), "--eval_batches", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 8 and np.all(np.isfinite(losses))
    assert [re.sub(r"\d+\.\d+", "<x>", line) for line in out] == [
        f"epoch {e}: 4 steps, loss <x> -> <x>, holdout AUC <x> logloss <x> (64 rows)"
        for e in range(2)]


def _standalone(extra, tmp_path):
    return port_main.main(["--model", "rm1", "--table_scale", str(SCALE), "--device", "cpu",
                           "--num_batches", "3", "--mini_batch_size", "16"] + extra)


def test_main_checkpoint_standalone_scores_the_trained_params(tmp_path):
    tr = _trained(steps=3)
    checkpoint.save_params(tmp_path / "ckpt", bridge.params_to_numpy(tr.params, tr.cfg))
    res = _standalone(["--checkpoint", str(tmp_path / "ckpt")], tmp_path)
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg, "cpu")
    batches = RecDataGenerator(cfg, seed=123).generate_batches(3, 16)
    with torch.inference_mode():
        for out, b in zip(res["outputs"], batches):
            torch.testing.assert_close(out, model.apply(tr.params, b.to("cpu")),
                                       rtol=1e-6, atol=0)
    random = _standalone([], tmp_path)["outputs"][0]
    assert not torch.equal(random, res["outputs"][0])


def test_main_checkpoint_queue_and_run_serving(tmp_path, monkeypatch):
    tr = _trained("ncf", steps=3)
    path = tmp_path / "ncf"
    checkpoint.save_params(path, bridge.params_to_numpy(tr.params, tr.cfg))
    handed = []
    pool = orchestrator.build_engine_pool

    def spy(*args, **kw):
        handed.append(args[8])
        return pool(*args, **kw)

    monkeypatch.setattr(orchestrator, "build_engine_pool", spy)
    res = port_main.main(["--model", "ncf", "--table_scale", str(SCALE), "--queue",
                          "--engine_backend", "cpu", "--inference_engines", "2",
                          "--num_batches", "12", "--avg_arrival_rate", "1",
                          "--checkpoint", str(path)])
    assert res.error_responses == 0 and res.num_responses == res.cpu_sub_requests > 0
    assert not res.engine_errors
    cfg = zoo.get_config("ncf", table_scale=SCALE)
    scfg = ServingConfig(engine_backend="cpu", num_batches=4, avg_arrival_rate_ms=1.0)
    run_serving(cfg, scfg, settle_s=0.0, checkpoint_path=str(path))
    assert len(handed) == 2
    for params in handed:
        for k, v in bridge.flatten(tr.params).items():
            assert torch.equal(bridge.flatten(params)[k], v), k
    # The engines score with them: a payload through one engine.
    from deeprecsys_tpu_torch.serving.engine import ComputeEngine
    from deeprecsys_tpu_torch.serving.packets import ServiceRequest
    import queue
    import time

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device="cpu", params=handed[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=60), Exception)
    payload = RecDataGenerator(cfg, seed=9).generate_batch(20)
    req_q.put(ServiceRequest(batch_id=0, batch_size=20, arrival_time=time.time(),
                             payload=payload))
    req_q.put(None)
    r = resp_q.get(timeout=60)
    eng.join(timeout=60)
    with torch.inference_mode():
        want = get_model(cfg, "cpu").apply(tr.params, payload.to("cpu")).numpy()
    np.testing.assert_allclose(r.scores, want, rtol=1e-6)


def test_quantized_checkpoints_are_not_served_yet(tmp_path):
    """(The name is historical: they are served now.) An export bundle
    serves standalone, scoring as model.apply on its own params, and
    through run_serving; tests/test_torch_quant.py holds both modes to the
    float checkpoint they come from."""
    tr = _trained(steps=1)
    sp, scfg = train.export_serving_params(tr.params, tr.cfg, "int8_rowwise")
    checkpoint.save_params(tmp_path / "q", bridge.params_to_numpy(sp, scfg))
    res = _standalone(["--checkpoint", str(tmp_path / "q"), "--table_quant", "int8_rowwise"],
                      tmp_path)
    batches = RecDataGenerator(scfg, seed=123).generate_batches(3, 16)
    with torch.inference_mode():
        for out, b in zip(res["outputs"], batches):
            assert torch.equal(out, get_model(scfg, "cpu").apply(sp, b.to("cpu")))
    served = run_serving(scfg, ServingConfig(engine_backend="cpu", num_batches=4,
                                             avg_arrival_rate_ms=1.0),
                         settle_s=0.0, checkpoint_path=str(tmp_path / "q"))
    assert served.error_responses == 0 and served.num_responses == served.cpu_sub_requests > 0
