"""The port's copies of the JAX package's framework-neutral layers equal
the originals: ``config``, ``zoo``, the CLI parser and
``model_config_from_args``, and the serving helpers. A change to either
copy that the other does not share fails here."""

import dataclasses

import numpy as np
import pytest

from deeprecsys_tpu import config as jax_config
from deeprecsys_tpu import main as jax_main
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.serving import buckets as jax_buckets
from deeprecsys_tpu.serving import latency_model as jax_lm
from deeprecsys_tpu.serving import load_generator as jax_lg
from deeprecsys_tpu.serving import metrics as jax_metrics
from deeprecsys_tpu.data import criteo as jax_criteo
from deeprecsys_tpu.utils import metrics_ml as jax_metrics_ml
from deeprecsys_tpu.serving import packets as jax_packets
from deeprecsys_tpu_torch import config, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.data import criteo
from deeprecsys_tpu_torch.serving import buckets, latency_model, load_generator, metrics, packets
from deeprecsys_tpu_torch.utils import memory, metrics_ml
from deeprecsys_tpu.utils import memory as jax_memory

DERIVED = ("num_tables", "scaled_rows", "table_offsets", "total_rows", "resolved_table_pack",
           "dense_dim", "num_fea", "top_in_dim", "ln_top", "out_dim", "behavior_table_ids",
           "fused_table_mb", "hotcold_auto_excluded")


def _assert_same_config(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in DERIVED:
        g, w = getattr(got, prop), getattr(want, prop)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, prop
            np.testing.assert_array_equal(g, w, err_msg=prop)
        else:
            assert g == w, prop


@pytest.mark.parametrize("scale", [1, 2000])
@pytest.mark.parametrize("name", jax_zoo.MODEL_NAMES)
def test_zoo_config_equals_jax(name, scale):
    assert zoo.MODEL_NAMES == jax_zoo.MODEL_NAMES
    _assert_same_config(zoo.get_config(name, table_scale=scale),
                        jax_zoo.get_config(name, table_scale=scale))


@pytest.mark.parametrize("name,overrides", [
    ("din", {"user_behavior_tables": 10}),
    ("din", {"user_behavior_tables": 0, "param_dtype": "bfloat16"}),
    ("dien", {"user_behavior_tables": 10, "hidden_size": 32}),
    ("rm1", {"param_dtype": "bfloat16", "compute_dtype": "bfloat16", "table_pack": 1}),
    ("ncf", {"output_head": "logits", "table_quant": "int8"}),
])
def test_zoo_overrides_equal_jax(name, overrides):
    """Overrides apply before DIN's expansion, in both."""
    _assert_same_config(zoo.get_config(name, table_scale=100, **overrides),
                        jax_zoo.get_config(name, table_scale=100, **overrides))


def test_dataclass_fields_and_defaults_equal_jax():
    """Equal but for the one stated difference: ServingConfig's
    engine_backend defaults to the card ("gpu") where the JAX package's
    defaults to its TPU."""
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(config.ModelConfig) == fields(jax_config.ModelConfig)
    got, want = fields(config.ServingConfig), fields(jax_config.ServingConfig)
    assert [f for f in got if f[0] != "engine_backend"] == \
        [f for f in want if f[0] != "engine_backend"]
    assert ("engine_backend", "str", "gpu") in got and ("engine_backend", "str", "tpu") in want
    port = dataclasses.asdict(config.ServingConfig())
    jax = dataclasses.asdict(jax_config.ServingConfig())
    assert (port.pop("engine_backend"), jax.pop("engine_backend")) == ("gpu", "tpu")
    assert port == jax
    _assert_same_config(config.ModelConfig(), jax_config.ModelConfig())


def test_engine_backend_is_the_one_stated_difference():
    """The port serves on "gpu", "cpu", "cpu-mp" or "sim"; "tpu" is
    refused. The JAX package takes "tpu", "cpu", "cpu-mp" and "sim"."""
    for backend in ("gpu", "cpu", "cpu-mp", "sim"):
        assert config.ServingConfig(engine_backend=backend).engine_backend == backend
    with pytest.raises(ValueError, match="port serves on 'gpu'"):
        config.ServingConfig(engine_backend="tpu")
    for backend in ("tpu", "cpu", "cpu-mp", "sim"):
        jax_config.ServingConfig(engine_backend=backend)


@pytest.mark.parametrize("kw", [
    {"model_type": "mlp"}, {"output_head": "probs"}, {"model_type": "wnd", "output_head": "logits"},
    {"interaction_op": "sum"}, {"model_type": "ncf", "embedding_rows": (4, 4, 4)},
    {"model_type": "ncf", "embedding_rows": (4,) * 4, "num_indices_per_lookup": 2},
    {"model_type": "dien", "embedding_rows": (4, 4, 4)},
])
def test_model_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_config.ModelConfig(**kw)
    with pytest.raises(ValueError) as got:
        config.ModelConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"engine_backend": "bogus"}, {"payload_arena_slots": 0},
                                {"hotcold_refresh_interval": 4, "hotcold_refresh_window": 1}])
def test_serving_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_config.ServingConfig(**kw)
    with pytest.raises(ValueError) as got:
        config.ServingConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw", [
    {"arch_mlp_bot": "13-512-256-64", "arch_mlp_top": "512-256-1",
     "arch_embedding_size": "1000-2000-3000", "arch_sparse_feature_size": 64,
     "arch_interaction_op": "dot", "arch_interaction_itself": True,
     "num_indices_per_lookup": 4, "num_indices_per_lookup_fixed": True,
     "model_type": "dlrm", "model_name": "custom"},
    {"arch_mlp_bot": "1", "arch_mlp_top": "200-80-2", "arch_embedding_size": "100-50-70-80",
     "arch_sparse_feature_size": 32, "num_indices_per_lookup": 3, "model_type": "din",
     "model_name": "din", "user_behavior_tables": 7},
])
def test_model_config_from_dict_equals_jax(raw, tmp_path):
    _assert_same_config(config.model_config_from_dict(raw, table_scale=3),
                        jax_config.model_config_from_dict(raw, table_scale=3))
    path = tmp_path / "cfg.json"
    path.write_text(__import__("json").dumps(raw))
    _assert_same_config(config.load_model_config(path, param_dtype="bfloat16"),
                        jax_config.load_model_config(path, param_dtype="bfloat16"))
    with pytest.raises(KeyError):
        config.model_config_from_dict({**raw, "arch_unknown": 1})


@pytest.mark.parametrize("kw", [
    {},
    {"bucket_policy": "auto", "batch_size_distribution": "normal",
     "avg_mini_batch_size": 165, "var_mini_batch_size": 16, "sub_task_batch_size": 32},
    {"bucket_policy": "auto", "batch_size_distribution": "lognormal", "avg_mini_batch_size": 4,
     "var_mini_batch_size": 0.8, "model_accel": True, "accel_request_size_thres": 200,
     "tune_batch_qps": True, "tune_accel_qps": True, "max_auto_buckets": 4, "seed": 5},
])
def test_resolve_buckets_equals_jax(kw):
    assert buckets.resolve_buckets(config.ServingConfig(**kw)) == \
        jax_buckets.resolve_buckets(jax_config.ServingConfig(**kw))


@pytest.mark.parametrize("k", [1, 3, 6, 50])
def test_bucket_ladder_and_padded_work_equal_jax(k):
    sizes = np.random.default_rng(k).integers(1, 300, size=500)
    ladder = buckets.optimal_bucket_ladder(sizes, k)
    assert ladder == jax_buckets.optimal_bucket_ladder(sizes, k)
    assert buckets.expected_padded_work(sizes, ladder) == \
        jax_buckets.expected_padded_work(sizes, ladder)


@pytest.mark.parametrize("dist", ["fixed", "normal", "lognormal", "file"])
def test_model_batch_sizes_equal_jax(dist, tmp_path):
    path = tmp_path / "dist.txt"
    path.write_text("\n".join(str(x) for x in (3, 17, 64, 200, 1500)) + "\n")
    kw = {"batch_size_distribution": dist, "num_batches": 257, "avg_mini_batch_size": 120,
          "var_mini_batch_size": 40, "max_mini_batch_size": 1024, "batch_dist_file": str(path)}
    if dist == "lognormal":
        kw.update(avg_mini_batch_size=4.5, var_mini_batch_size=1.0)
    got = load_generator.model_batch_sizes(config.ServingConfig(**kw), np.random.default_rng(9))
    want = jax_lg.model_batch_sizes(jax_config.ServingConfig(**kw), np.random.default_rng(9))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,sub", [(1, 32), (32, 32), (165, 32), (1000, 7), (0, 4)])
def test_partition_query_equals_jax(size, sub):
    assert load_generator.partition_query(size, sub) == jax_lg.partition_query(size, sub)


def test_partition_query_rejects_nonpositive_sub_batches():
    for fn in (load_generator.partition_query, jax_lg.partition_query):
        with pytest.raises(ValueError, match="positive"):
            fn(10, 0)


def test_parser_defaults_equal_jax():
    port = vars(port_main.build_parser().parse_args([]))
    want = vars(jax_main.build_parser().parse_args([]))
    assert port.pop("device") == "cuda"
    assert (port.pop("engine_backend"), want["engine_backend"]) == ("gpu", "tpu")
    assert {k: want[k] for k in port} == port


@pytest.mark.parametrize("argv", [
    [],
    ["--queue", "--inference_engines", "4", "--batch_size_distribution", "normal",
     "--avg_mini_batch_size", "165", "--var_mini_batch_size", "16", "--sub_task_batch_size",
     "32", "--avg_arrival_rate", "5", "--target_latency", "20", "--tune_batch_qps",
     "--batch_configs", "32-64", "--arr_steps", "5", "--sched_timeout", "4",
     "--numpy_rand_seed", "7", "--bucket_policy", "auto", "--max_auto_buckets", "4"],
    ["--model_accel", "--accel_request_size_thres", "300", "--tune_accel_qps",
     "--accel_configs", "200-400", "--coalesce_requests", "--max_coalesce", "3",
     "--accept_ragged", "--hotcold_refresh_interval", "2", "--hotcold_refresh_margin", "0.1",
     "--hotcold_refresh_window", "5", "--hotcold_scan_budget", "300", "--hotcold_scan_sync",
     "--stable_region", "0.2", "--min_arr_range", "2",
     "--max_arr_range", "50", "--req_granularity", "16", "--nepochs", "3",
     "--num_batches", "11", "--max_mini_batch_size", "512", "--debug_mode",
     "--log_file", "x.log", "--batch_dist_file", "d.txt"],
])
def test_serving_config_from_args_equals_jax(argv):
    """The same ServingConfig from the same flags, but the engine backend
    (each package's default)."""
    got = port_main.serving_config_from_args(port_main.build_parser().parse_args(argv))
    want = jax_main.serving_config_from_args(jax_main.build_parser().parse_args(argv))
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert (got.pop("engine_backend"), want.pop("engine_backend")) == ("gpu", "tpu")
    assert got == want


def test_packets_equal_jax():
    """Fields, defaults, error codes and messages of the packet copies."""
    for cls in ("ServiceRequest", "ServiceResponse"):
        got = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(packets, cls))]
        want = [(f.name, f.type, f.default)
                for f in dataclasses.fields(getattr(jax_packets, cls))]
        assert got == want, cls
    names = [n for n in dir(jax_packets) if n.startswith("ERR_")] + ["RELOAD_ACK_BATCH_ID"]
    assert [getattr(packets, n) for n in names] == [getattr(jax_packets, n) for n in names]
    assert packets.ERROR_MESSAGES == jax_packets.ERROR_MESSAGES
    for code in (0, 3, 5, 77):
        assert packets.ServiceResponse(error_code=code, arrival_time=1.0,
                                       inference_end_time=3.5).error_message() == \
            jax_packets.ServiceResponse(error_code=code).error_message()
    assert packets.ServiceResponse(arrival_time=1.0, inference_end_time=3.5).latency() == 2.5


def test_response_aggregator_equals_jax():
    """The same responses, in the same order, give both aggregators the same
    windowed p95 feed, latencies, error counts, QPS and tails."""
    rng = np.random.default_rng(3)
    port, jax = metrics.ResponseAggregator(4), jax_metrics.ResponseAggregator(4)
    feed_port, feed_jax = [], []
    events = []
    for q in range(60):
        parts = int(rng.integers(1, 5))
        arrival = q * 0.01
        for sub in range(parts):
            events.append(dict(epoch=q % 2, batch_id=q, sub_id=sub, total_sub_batches=parts,
                               arrival_time=arrival + 1e-4 * sub,
                               inference_end_time=arrival + float(rng.uniform(0.001, 0.05)),
                               exp_packet=q < 8, error_code=int(rng.random() < 0.05) * 3))
    for i in rng.permutation(len(events)):
        feed_port.append(port.add(packets.ServiceResponse(**events[i])))
        feed_jax.append(jax.add(jax_packets.ServiceResponse(**events[i])))
    assert feed_port == feed_jax and any(f is not None for f in feed_port)
    assert port.latencies == jax.latencies and port.final_latencies == jax.final_latencies
    assert port.error_counts == jax.error_counts
    assert port.measured_qps() == jax.measured_qps()
    for pct in (50, 95, 99):
        assert port.tail_latency_ms(pct) == jax.tail_latency_ms(pct)
    assert np.isnan(metrics.ResponseAggregator().tail_latency_ms(95))


@pytest.mark.parametrize("kind", ["plain", "overhead", "overlap", "single"])
def test_latency_model_equals_jax(kind, tmp_path):
    """Predictions on a grid of batch sizes (clamp, exact hits,
    interpolation, extrapolation), the JSON round-trip and the reference
    raw-file reader."""
    ladder = ([1, 4, 16, 64, 256], [0.2, 0.5, 1.1, 2.0, 5.5]) if kind != "single" \
        else ([8], [1.5])
    port, jax = latency_model.LatencyModel(*ladder), jax_lm.LatencyModel(*ladder)
    if kind == "overhead":
        port, jax = port.with_overhead(0.3, 0.01), jax.with_overhead(0.3, 0.01)
    elif kind == "overlap":
        port, jax = port.with_overlap(0.3, 0.02), jax.with_overlap(0.3, 0.02)
    for b in (0, 1, 3, 4, 7, 16, 100, 256, 1000, 4096):
        assert port.predict_ms(b) == jax.predict_ms(b), b
    assert port.to_json() == jax.to_json()
    back = latency_model.LatencyModel.from_json(port.to_json())
    assert [back.predict_ms(b) for b in (5, 500)] == [jax.predict_ms(b) for b in (5, 500)]
    path = tmp_path / "lm.json"
    port.save(path)
    assert latency_model.LatencyModel.load(path).to_json() == jax_lm.LatencyModel.load(path).to_json()
    raw = tmp_path / "results.txt"
    raw.write_text("".join(f"x *** {v} ms\n" for v in (1, 2, 3, 4, 5, 6.5, 1, 2, 3, 4, 5, 9.0)))
    assert latency_model.LatencyModel.from_reference_raw(raw).to_json() == \
        jax_lm.LatencyModel.from_reference_raw(raw).to_json()
    with pytest.raises(ValueError):
        latency_model.LatencyModel([1, 2], [1.0])


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "din", "--table_scale", "2000", "--param_dtype", "bfloat16"],
    ["--model", "dien", "--compute_dtype", "float32", "--param_dtype", "bfloat16",
     "--output_head", "logits", "--table_pack", "1"],
    ["--model", "rm2", "--embedding_impl", "hotcold", "--hot_set_rows", "4096",
     "--hotcold_min_hit", "0.5", "--hotcold_min_table_mb", "64", "--table_quant", "int8"],
])
def test_model_config_from_args_equals_jax(argv):
    got = port_main.model_config_from_args(port_main.build_parser().parse_args(argv))
    want = jax_main.model_config_from_args(jax_main.build_parser().parse_args(argv))
    _assert_same_config(got, want)


def test_criteo_model_raises_in_the_port():
    """``--model criteo`` raised until the dataset mode was ported; it now
    gives the JAX CLI's config."""
    for argv in ([], ["--table_scale", "1000", "--param_dtype", "bfloat16", "--table_pack", "1"]):
        argv = ["--model", "criteo"] + argv
        got = port_main.model_config_from_args(port_main.build_parser().parse_args(argv))
        want = jax_main.model_config_from_args(jax_main.build_parser().parse_args(argv))
        _assert_same_config(got, want)


@pytest.mark.parametrize("kw", [{}, {"rows_per_table": 1000, "d": 64,
                                     "mlp_bot": (13, 128, 64), "mlp_top": (128, 1)}])
def test_criteo_config_equals_jax(kw):
    _assert_same_config(criteo.criteo_model_config(**kw), jax_criteo.criteo_model_config(**kw))


@pytest.mark.parametrize("signal", [False, True])
def test_criteo_reader_and_writer_equal_jax(signal, tmp_path):
    criteo.write_synthetic_criteo(tmp_path / "p.tsv", 150, seed=4, missing_rate=0.2,
                                  signal=signal)
    jax_criteo.write_synthetic_criteo(tmp_path / "j.tsv", 150, seed=4, missing_rate=0.2,
                                      signal=signal)
    assert (tmp_path / "p.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    with open(tmp_path / "p.tsv", "a") as f:  # a CRLF line and a short one
        f.write("1\t5" + "\t" * 37 + "\r\n0\t3\n")
    cfg = criteo.criteo_model_config(rows_per_table=777)
    jcfg = jax_criteo.criteo_model_config(rows_per_table=777)
    got = list(criteo.CriteoReader(tmp_path / "p.tsv", cfg).batches(38, max_batches=3))
    want = list(jax_criteo.CriteoReader(tmp_path / "p.tsv", jcfg).batches(38, max_batches=3))
    assert len(got) == len(want) == 3
    for (gb, gl), (wb, wl) in zip(got, want):
        np.testing.assert_array_equal(gb.dense, wb.dense)
        np.testing.assert_array_equal(gb.indices, wb.indices)
        np.testing.assert_array_equal(gl, wl)
    for h in ("", "0", "ffffffff", "zz9", "68fd1e64"):
        assert criteo._hash_hex(h, 777) == jax_criteo._hash_hex(h, 777)


@pytest.mark.parametrize("bad", [{"embedding_rows": (10,) * 3}, {"num_indices_per_lookup": 2}])
def test_criteo_reader_validation_equals_jax(bad):
    with pytest.raises(ValueError) as got:
        criteo.CriteoReader("x", criteo.criteo_model_config(rows_per_table=10).replace(**bad))
    with pytest.raises(ValueError) as want:
        jax_criteo.CriteoReader("x", jax_criteo.criteo_model_config(rows_per_table=10)
                                .replace(**bad))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_equals_jax(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random(500), 2)  # ties
    labels = rng.random(500) < 0.3
    assert metrics_ml.auc(scores, labels) == jax_metrics_ml.auc(scores, labels)
    assert np.isnan(metrics_ml.auc(scores, np.zeros(500))) and np.isnan(
        jax_metrics_ml.auc(scores, np.zeros(500)))


def test_native_runtime_source_is_a_byte_equal_copy():
    """The port's native splitter is its own copy of the JAX package's C++
    source, built into the port's own directory."""
    from pathlib import Path

    from deeprecsys_tpu_torch.runtime import native

    root = Path(__file__).resolve().parents[1]
    original = root / "deeprecsys_tpu" / "runtime" / "cpp" / "drs_runtime.cpp"
    assert native.SRC == root / "deeprecsys_tpu_torch" / "runtime" / "cpp" / "drs_runtime.cpp"
    assert native.SRC.read_bytes() == original.read_bytes()
    assert native.BUILD_DIR == root / "build" / "native"


@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", jax_zoo.MODEL_NAMES)
def test_memory_sizes_equal_jax(name, dtype, quant):
    """model_memory_bytes, fits_hbm and suggest_hot_rows of the same config
    in both packages; the 8 MB default keeps the JAX hot-set sizes (rm1
    bf16: 131,072 rows, int8 262,144, int8_rowwise 233,016)."""
    kw = dict(param_dtype=dtype, table_quant=quant)
    cfg, jcfg = zoo.get_config(name, **kw), jax_zoo.get_config(name, **kw)
    assert memory.model_memory_bytes(cfg) == jax_memory.model_memory_bytes(jcfg)
    for hbm in (16 * 2**30, 80 * 2**30, 2**20):
        assert memory.fits_hbm(cfg, hbm) == jax_memory.fits_hbm(jcfg, hbm)
    assert memory.suggest_hot_rows(cfg) == jax_memory.suggest_hot_rows(jcfg)
    assert memory.suggest_hot_rows(cfg, 1 << 16) == jax_memory.suggest_hot_rows(jcfg, 1 << 16)
    if name == "rm1" and dtype == "bfloat16":
        assert memory.suggest_hot_rows(cfg) == {"none": 131_072, "int8": 262_144,
                                                "int8_rowwise": 233_016}[quant]
