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
from deeprecsys_tpu.serving import load_generator as jax_lg
from deeprecsys_tpu_torch import config, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch.serving import buckets, load_generator

DERIVED = ("num_tables", "scaled_rows", "table_offsets", "total_rows", "resolved_table_pack",
           "dense_dim", "num_fea", "top_in_dim", "ln_top", "out_dim", "behavior_table_ids")


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
    for cls in ("ModelConfig", "ServingConfig"):
        got = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(config, cls))]
        want = [(f.name, f.type, f.default) for f in dataclasses.fields(getattr(jax_config, cls))]
        assert got == want, cls
    assert dataclasses.asdict(config.ServingConfig()) == \
        dataclasses.asdict(jax_config.ServingConfig())
    _assert_same_config(config.ModelConfig(), jax_config.ModelConfig())


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


@pytest.mark.parametrize("kw", [{"engine_backend": "gpu"}, {"payload_arena_slots": 0},
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
    assert {k: want[k] for k in port} == port


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
    args = port_main.build_parser().parse_args(["--model", "criteo"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_main.model_config_from_args(args)
