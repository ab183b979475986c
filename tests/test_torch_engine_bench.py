"""``engine_bench`` (closed-loop engine capacity) on the CPU at a small size:
every arm runs and counts what it served; the engine arm drives the JAX
package's pool through the same arguments."""

import json

import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.serving.engine import build_engine_pool as jax_build_engine_pool
from deeprecsys_tpu.serving.packets import ServiceRequest as JaxServiceRequest
from deeprecsys_tpu_torch import engine_bench, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model

SCALE = 2000


@pytest.mark.parametrize("engines", [1, 2])
def test_engine_arm_serves_every_request(engines):
    r = engine_bench.engine_arm(zoo.get_config("rm1", table_scale=SCALE), "cpu", engines,
                                24, 8)
    assert (r["arm"], r["threads"], r["executions"]) == ("engine", engines, 24)
    assert r["executions_per_s"] > 0 and r["inference_p50_ms"] > 0
    assert "exec/s" in engine_bench.describe(r)


def test_engine_arm_drives_the_jax_pool():
    r = engine_bench.engine_arm(jax_zoo.get_config("rm1", table_scale=SCALE), "cpu", 1, 12, 8,
                                pool_fn=jax_build_engine_pool, config_cls=JaxServingConfig,
                                request_cls=JaxServiceRequest)
    assert r["executions"] == 12 and r["executions_per_s"] > 0


def test_loop_arm_eager_on_the_cpu_and_graph_needs_a_card():
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = RecDataGenerator(cfg, seed=1).generate_batch(8)
    r = engine_bench.loop_arm(model, params, batch, torch.device("cpu"), 2, 5, graph=False)
    assert (r["arm"], r["threads"], r["executions"]) == ("eager", 2, 10)
    with pytest.raises(ValueError, match="CUDA graphs"):
        engine_bench.loop_arm(model, params, batch, torch.device("cpu"), 1, 1, graph=True)


def test_bench_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine_bench.main(["--table_scale", str(SCALE), "--executions", "4"])


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_bench_runs_with_int8_tables_on_the_cpu(quant, tmp_path):
    engine_bench.main(["--table_scale", str(SCALE), "--executions", "6", "--engines", "1",
                       "--device", "cpu", "--table_quant", quant,
                       "--json", str(tmp_path / "eb.json")])
    out = json.loads((tmp_path / "eb.json").read_text())
    assert out["table_quant"] == quant
    assert [r["arm"] for r in out["rows_by_arm"]] == ["engine", "eager"]


def test_bench_runs_hotcold_engines_on_the_cpu(tmp_path):
    """--embedding_impl hotcold: the engine arm alone, its engines splitting
    every request."""
    engine_bench.main(["--table_scale", str(SCALE), "--executions", "6", "--engines", "1",
                       "--device", "cpu", "--embedding_impl", "hotcold",
                       "--json", str(tmp_path / "eb.json")])
    out = json.loads((tmp_path / "eb.json").read_text())
    assert out["embedding_impl"] == "hotcold"
    assert [r["arm"] for r in out["rows_by_arm"]] == ["engine"]
    assert out["rows_by_arm"][0]["executions"] == 6
