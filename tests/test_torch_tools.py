"""The port's tools (``deeprecsys_tpu_torch/tools/``) on the CPU, each on a
short run with its record written to ``tmp_path``: the refresh scan's hot
sets and coverages and mesh_bench's descriptor counters equal the JAX
package's exactly, the sim half of sim_revalidate answers the JAX sim's
count, and the soaks hold their accounting. No tool writes under
``benchmarks/``, and each raises on ``--device cuda`` without a card."""

import dataclasses
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.ops.embedding import hot_coverage_of as jax_hot_coverage_of
from deeprecsys_tpu.ops.embedding import scan_budget_subsample as jax_scan_budget_subsample
from deeprecsys_tpu.ops.embedding import select_hot_ids as jax_select_hot_ids
from deeprecsys_tpu.serving import run_serving as jax_run_serving
from deeprecsys_tpu.serving.latency_model import LatencyModel as JaxLatencyModel
from deeprecsys_tpu.utils.memory import suggest_hot_rows as jax_suggest_hot_rows
from deeprecsys_tpu_torch import ServingConfig
from deeprecsys_tpu_torch.runtime import native
from deeprecsys_tpu_torch.tools import (
    common, cpu_mp_soak, mesh_bench, ragged_hotcold_soak, refresh_scan_cost, sim_revalidate)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("refresh_scan_cost", "sim_revalidate", "mesh_bench", "cpu_mp_soak",
         "ragged_hotcold_soak")
LADDER = {"batch_sizes": [1, 64, 256, 1024], "latencies_ms": [0.3, 0.4, 0.5, 0.7], "base": 4.0,
          "table_scale": 1, "dtype": "bfloat16", "device": "a hand-written test ladder",
          "power_limit": "none"}


def _benchmarks() -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in (ROOT / "benchmarks").rglob("*") if p.is_file()}


@pytest.fixture
def one_thread():
    """One intra-op thread while a soak runs: its requests then keep their
    pace beside the other test workers, which share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _run(tool, argv: list, out: Path) -> dict:
    """``tool.main(argv + --out out)``: its record, returned and on disk the
    same, and nothing under ``benchmarks/`` written."""
    before = _benchmarks()
    rec = tool.main(argv + ["--out", str(out)])
    assert _benchmarks() == before
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    return rec


def test_refresh_scan_cost_sets_and_coverages_equal_jax(tmp_path, monkeypatch):
    """rm1 at table_scale 20 (a hot set smaller than the tables, a window
    past the scan budget): the capped and uncapped hot sets the tool's run
    selects and both coverages it records equal JAX's
    ``select_hot_ids``/``hot_coverage_of`` on the same window."""
    scale, seen = 20, {}
    orig = refresh_scan_cost.scan_window

    def scan_window(cfg, batches):
        seen["batches"], seen["got"] = batches, orig(cfg, batches)
        return seen["got"]

    monkeypatch.setattr(refresh_scan_cost, "scan_window", scan_window)
    rec = _run(refresh_scan_cost, ["--models", "rm1", "--table-scale", str(scale),
                                   "--device", "cpu"], tmp_path / "scan.json")
    batches, got = seen["batches"], seen["got"]
    jcfg = jax_zoo.get_config("rm1", table_scale=scale, param_dtype="bfloat16")
    offs, k = np.asarray(jcfg.table_offsets), jax_suggest_hot_rows(jcfg)
    n_hold = max(1, refresh_scan_cost.WINDOW // 4)
    sel, hold = np.concatenate(batches[:-n_hold]), np.concatenate(batches[-n_hold:])
    assert sel.size > refresh_scan_cost.BUDGET and got["k"] == k < jcfg.total_rows
    hot_u = np.asarray(jax_select_hot_ids(sel, offs, k))
    hot_c = np.asarray(jax_select_hot_ids(
        jax_scan_budget_subsample(sel, refresh_scan_cost.BUDGET), offs, k))
    np.testing.assert_array_equal(got["hot_uncapped"], hot_u)
    np.testing.assert_array_equal(got["hot_capped"], hot_c)
    cov_u = float(jax_hot_coverage_of(hold, offs, hot_u))
    cov_c = float(jax_hot_coverage_of(hold, offs, hot_c))
    assert 0 < cov_c < 1
    r = rec["results"]["rm1"]
    assert r["coverage_uncapped_set"] == cov_u and r["coverage_capped_set_full_holdout"] == cov_c
    assert r["hot_rows_k"] == k and r["uncapped_ms"] > 0 and r["capped_ms"] > 0
    assert r["lookups_scanned_M"] == sel.size / 1e6 and rec["card"] == "host CPU"


def test_mesh_bench_counters_equal_jax_tool(tmp_path):
    """A 2x4 run on ``["cpu"] * 8`` (virtual) at rm1 table_scale 20000:
    samples/s > 0, K1's window D*M times a forward, and the descriptor
    counters equal the JAX tool's dict and obey its law
    (``tests/test_parallel.py:561-564``)."""
    sys.path.insert(0, str(ROOT / "tools"))
    jax_mesh_bench = importlib.import_module("mesh_bench")
    rec = _run(mesh_bench, ["--mesh", "2x4", "--models", "rm1", "--batch", "16", "--iters", "4",
                            "--table-scale", "20000", "--device", "cpu"], tmp_path / "mesh.json")
    assert rec["virtual"] is True and rec["devices"] == 8 and rec["entries"] == ["cpu"] * 8
    r = rec["results"]["rm1"]
    assert r["latency_ms"] > 0 and r["samples_per_s"] > 0 and r["forwards"] == 9
    facts = mesh_bench.factorizations(2, 4)
    assert facts == [(1, 8), (2, 4), (4, 2), (8, 1)]
    want = jax_mesh_bench.descriptor_counters("rm1", 20000, 16, facts)
    assert rec["descriptor_counters"]["rm1"] == json.loads(json.dumps(want))
    for key, v in rec["descriptor_counters"]["rm1"].items():
        d, m = (int(x) for x in key.split("x"))
        flat = [x for row in v["per_chip_descriptors"] for x in row]
        assert v["max_chip_descriptors"] <= max(v["ideal_per_chip"] * 1.5, 8)
        assert sum(flat) == v["n_cold_total"] and len(flat) == d * m


def test_sim_revalidate_sim_half_equals_jax(tmp_path):
    """Over a given ladder: the sim half answers exactly the JAX sim's
    num_responses at the same operating point, and the real half (CPU
    engines, a rehearsal) answers the same queries; --sensitivity scales
    the ladder and says so."""
    (tmp_path / "gpu_rm1.json").write_text(json.dumps(LADDER))
    argv = ["rm1", "--device", "cpu", "--ladder-dir", str(tmp_path), "--table-scale", "2000",
            "--num-batches", "16"]
    rec = _run(sim_revalidate, argv, tmp_path / "sim.json")
    r = rec["results"]["rm1"]
    jcfg = JaxServingConfig(**dataclasses.asdict(sim_revalidate.mk_cfg("sim", 16)))
    want = jax_run_serving(jax_zoo.get_config("rm1", table_scale=8), jcfg,
                           latency_model=JaxLatencyModel(LADDER["batch_sizes"],
                                                         LADDER["latencies_ms"]),
                           settle_s=0.05)
    assert r["sim"]["n"] == want.num_responses == r["real"]["n"] > 16
    assert r["real"]["engine_backend"] == "cpu" and r["real"]["executions"] > 0
    assert r["sim"]["executions"] == 0 and np.isfinite(r["p95_rel_err"])
    assert r["ladder"]["device"] == LADDER["device"] and r["table_scale"] == 2000
    sens = _run(sim_revalidate, argv[:1] + ["--sensitivity"] + argv[1:] + ["--num-batches", "4"],
                tmp_path / "sens.json")
    s = sens["results"]["rm1"]
    assert [row["ladder_scale"] for row in s["sweep"]] == list(sim_revalidate.SCALES)
    assert "ladder" in s["scaled"] and np.isfinite(s["p95_amplification_per_unit_scale"])


@pytest.mark.skipif(not native.native_available(), reason="native runtime not built (no g++)")
def test_cpu_mp_soak_exhaustion_cycle(tmp_path, one_thread):
    """A few seconds of cpu-mp soak with the offload engine (on the CPU
    here) and one exhaustion cycle: 0 errors, 503s at the wall, a
    recovered 200, every slot back at quiesce, both /v1/infer routes."""
    rec = _run(cpu_mp_soak, ["--minutes", "0.06", "--sample-s", "1.2",
                             "--first-exhaustion-s", "1.2", "--accel", "--device", "cpu"],
               tmp_path / "soak.json")
    assert rec["status"] == "done" and rec["n_errors"] == 0, rec["errors"]
    (cycle,) = rec["exhaustion_cycles"]
    slots = ServingConfig().payload_arena_slots
    assert cycle["n_503"] >= 1 and cycle["recovered_200"] and cycle["slots_staged"] == slots, cycle
    assert rec["slots_leaked_at_quiesce"] == 0 == rec["payload_slots_in_flight_at_quiesce"]
    summary = {k: v for k, v in rec.items() if k != "samples"}
    assert rec["predict_ok"] > 0, summary
    assert rec["infer_accel_ok"] > 0 and rec["infer_child_ok"] > 0, summary
    assert rec["accel_executions"] >= rec["infer_accel_ok"], summary
    assert len(rec["samples"]) >= 2 and rec["rss_first_half_mb"] > 0, rec["samples"]


def test_ragged_hotcold_soak_refreshes(tmp_path, one_thread):
    """A few seconds of ragged traffic on the hot/cold engine (CPU) with a
    short phase: 0 errors, at least one refresh, a clean shutdown."""
    rec = _run(ragged_hotcold_soak, ["--minutes", "0.1", "--phase-requests", "20",
                                     "--sample-s", "2", "--device", "cpu"],
               tmp_path / "ragged.json")
    assert rec["errors"] == 0 and rec["requests_ok"] > 0
    assert rec["hot_refreshes"] >= 1 and rec["clean_shutdown"]
    assert rec["p95_ms"] >= rec["p50_ms"] > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", TOOLS)
def test_tools_raise_on_cuda_without_a_card(name, tmp_path):
    tool = importlib.import_module(f"deeprecsys_tpu_torch.tools.{name}")
    argv = ["--device", "cuda", "--out", str(tmp_path / "x.json")]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv + (["--mesh", "1x4"] if name == "mesh_bench" else []))
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("name", TOOLS)
def test_tools_default_out_is_not_benchmarks(name):
    """Each tool's default record path is under chiprun_out/tools/, and no
    tool's source names ``benchmarks/`` as a place to write."""
    assert common.OUT_DIR == ROOT / "chiprun_out" / "tools"
    src = (ROOT / "deeprecsys_tpu_torch" / "tools" / f"{name}.py").read_text()
    assert "benchmarks" not in src
    assert 'default_out("' in src
