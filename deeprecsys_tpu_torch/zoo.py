"""The eight industry-representative model configurations.

Counterpart of ``deeprecsys_tpu/zoo.py:19-102``, copied so that the port
imports nothing of the JAX package (``tests/test_torch_config.py`` holds
the two equal). Values mirror the reference's shipped JSON configs
(``models/configs/{dlrm_rm1,dlrm_rm2,dlrm_rm3,wide_and_deep,mtwnd,ncf,din,
dien}.json``). DIN is stored before its behavior-table expansion, which
``get_config`` applies after any overrides. MT-WnD uses 4 task heads and
DIEN a hidden size of 64 (reference CLI defaults not in the JSON).
"""

from __future__ import annotations

from deeprecsys_tpu_torch.config import ModelConfig, _expand_din_tables

MODEL_NAMES = ("rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")

_ZOO = {
    "rm1": ModelConfig(
        model_type="dlrm", model_name="rm1",
        mlp_bot=(128, 64, 32), mlp_top=(256, 64, 1),
        embedding_rows=(4_000_000,) * 8,
        sparse_feature_size=32, num_indices_per_lookup=80,
        interaction_op="cat",
    ),
    "rm2": ModelConfig(
        model_type="dlrm", model_name="rm2",
        mlp_bot=(256, 128, 64), mlp_top=(128, 64, 1),
        embedding_rows=(500_000,) * 32,
        sparse_feature_size=64, num_indices_per_lookup=120,
        interaction_op="cat",
    ),
    "rm3": ModelConfig(
        model_type="dlrm", model_name="rm3",
        mlp_bot=(2560, 1024, 256, 32), mlp_top=(512, 256, 1),
        embedding_rows=(2_000_000,) * 10,
        sparse_feature_size=32, num_indices_per_lookup=20,
        interaction_op="cat",
    ),
    "wnd": ModelConfig(
        model_type="wnd", model_name="wnd",
        mlp_bot=(512,), mlp_top=(1024, 512, 256, 1),
        embedding_rows=(1_000_000,) * 27,
        sparse_feature_size=32, num_indices_per_lookup=1,
        interaction_op="cat",
    ),
    "mtwnd": ModelConfig(
        model_type="mtwnd", model_name="mtwnd",
        mlp_bot=(512,), mlp_top=(1024, 512), mlp_tasks=(512, 256, 128),
        num_multi_tasks=4,
        embedding_rows=(500_000,) * 41 + (5_000_000,) * 2,
        sparse_feature_size=32, num_indices_per_lookup=1,
        interaction_op="cat",
    ),
    "ncf": ModelConfig(
        model_type="ncf", model_name="ncf",
        mlp_bot=(512,), mlp_top=(256, 256, 128, 64, 64),
        embedding_rows=(140_000, 140_000, 28_000, 28_000),
        sparse_feature_size=64, num_indices_per_lookup=1,
        interaction_op="cat",
    ),
    "din": ModelConfig(
        model_type="din", model_name="din",
        mlp_bot=(1,), mlp_top=(200, 80, 2),
        embedding_rows=(1_000_000, 100_000, 10_000_000, 10_000_000),
        sparse_feature_size=32, num_indices_per_lookup=3,
        interaction_op="cat", user_behavior_tables=250,
    ),
    "dien": ModelConfig(
        model_type="dien", model_name="dien",
        mlp_bot=(512,), mlp_top=(200, 80, 2),
        embedding_rows=(500_000,) * 41 + (5_000_000,) * 2,
        sparse_feature_size=32, num_indices_per_lookup=1,
        interaction_op="cat", hidden_size=64,
    ),
}


def get_config(name: str, table_scale: int = 1, **overrides) -> ModelConfig:
    """A zoo config with its overrides, then DIN's expansion applied.

    ``table_scale`` divides all table row counts (tests and small runs;
    1 = full production sizes).
    """
    cfg = _ZOO[name]
    if overrides:
        # Before the expansion, so that a user_behavior_tables override
        # sizes it (as the JSON path, config.model_config_from_dict).
        cfg = cfg.replace(**overrides)
    if cfg.model_type == "din" and len(cfg.embedding_rows) == 4:
        cfg = cfg.replace(
            embedding_rows=_expand_din_tables(cfg.embedding_rows, cfg.user_behavior_tables))
    if table_scale != 1:
        cfg = cfg.replace(table_scale=table_scale)
    return cfg
