"""Configuration for models and serving.

Counterpart of ``deeprecsys_tpu/config.py`` (``ModelConfig`` :40-296, the
JSON loader :297-351, ``ServingConfig`` :360-507), copied so that the port
imports nothing of the JAX package. Fields, defaults and validation are the
same, the TPU-only knobs included (``table_pack``, ``embedding_impl``,
the hot/cold and coalescing fields): a config means the same thing to both
packages, and ``tests/test_torch_config.py`` holds every field, default and
derived property here equal to the original. The port rejects the knobs
whose paths it has not ported where it meets them.

As in the original, the DIN behavior-table expansion (reference
``utils/utils.py:132-149``) runs after the JSON merge and after overrides.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

import numpy as np

MODEL_TYPES = ("dlrm", "wnd", "mtwnd", "ncf", "din", "dien")


def _parse_dims(s: str | Sequence[int]) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(int(x) for x in s.split("-") if x != "")
    return tuple(int(x) for x in s)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture configuration for one recommendation model.

    Field semantics mirror the reference CLI flags of the same name
    (``utils/utils.py:22-35``).
    """

    model_type: str = "dlrm"
    model_name: str = "dlrm"
    sparse_feature_size: int = 32                 # --arch_sparse_feature_size
    embedding_rows: tuple[int, ...] = (4, 3, 2)   # --arch_embedding_size
    mlp_bot: tuple[int, ...] = (4, 3, 2)
    mlp_top: tuple[int, ...] = (4, 2, 1)
    mlp_tasks: tuple[int, ...] = (4, 2, 1)
    num_multi_tasks: int = 1
    hidden_size: int = 64                         # DIEN's RNN width
    interaction_op: str = "dot"                   # "dot" | "cat" (DLRM only)
    interaction_itself: bool = False
    num_indices_per_lookup: int = 1               # pooling factor L
    user_behavior_tables: int = 1000              # DIN's extra behavior tables
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # The JAX package's lookup implementations: "xla" (the direct fused
    # lookup: K1, K1-int8 or K4), "hotcold" and "auto" (serving engines
    # only: a hot/cold split, K6, or by the sampled coverage either one).
    embedding_impl: str = "xla"
    hot_set_rows: int = 0
    hotcold_min_hit: float = 0.75
    hotcold_min_table_mb: float = 128.0
    table_quant: str = "none"                     # "none" | "int8" | "int8_rowwise"
    # Row packing for the TPU's 128-byte gather granule (0 = auto). The
    # port keeps the unpacked layout and reads packed checkpoints through
    # bridge.params_from_numpy.
    table_pack: int = 0
    table_scale: int = 1                          # divide every table's rows
    output_head: str = "reference"                # "reference" | "logits"

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type!r}; expected one of {MODEL_TYPES}")
        if self.output_head not in ("reference", "logits"):
            raise ValueError(f"unknown output_head {self.output_head!r} "
                             "(valid: 'reference', 'logits')")
        if self.output_head == "logits" and self.model_type in (
                "dlrm", "wnd", "mtwnd"):
            raise ValueError(
                f"output_head='logits' applies to the relu-scored families "
                f"(ncf/din/dien); {self.model_type} ends in a sigmoid whose "
                f"monotone scores need no logit head")
        if self.interaction_op not in ("dot", "cat"):
            raise ValueError(f"unknown interaction_op {self.interaction_op!r}")
        if self.model_type == "ncf":
            # Reference assertions: ncf.py:348-356.
            if len(self.embedding_rows) != 4:
                raise ValueError("NCF requires exactly 4 embedding tables")
            if self.num_indices_per_lookup != 1:
                raise ValueError("NCF requires 1 index per lookup")
        if self.model_type in ("din", "dien") and len(self.embedding_rows) < 4:
            # Reference assertions: din.py / dien.py:456.
            raise ValueError(f"{self.model_type} requires >= 4 embedding tables")

    # ------------------------------------------------------------------
    # Derived dimensions
    # ------------------------------------------------------------------

    @property
    def num_tables(self) -> int:
        return len(self.embedding_rows)

    @property
    def scaled_rows(self) -> tuple[int, ...]:
        if self.table_scale == 1:
            return self.embedding_rows
        return tuple(max(4, n // self.table_scale) for n in self.embedding_rows)

    @property
    def table_offsets(self) -> np.ndarray:
        """Row offset of each table inside the fused (total_rows, d) array."""
        return np.concatenate([[0], np.cumsum(self.scaled_rows)[:-1]]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(np.sum(self.scaled_rows))

    @property
    def fused_table_mb(self) -> float:
        """Fused table size in MB at the serving layout: what
        ``hotcold_min_table_mb``, ``embedding_impl="auto"``'s size floor,
        is compared with (JAX ``config.py:185``)."""
        itemsize = (1 if self.table_quant in ("int8", "int8_rowwise")
                    else 2 if self.param_dtype == "bfloat16" else 4)
        return self.total_rows * self.sparse_feature_size * itemsize / 1e6

    @property
    def resolved_table_pack(self) -> int:
        """The JAX package's pack factor (0 = auto resolved): narrow rows
        packed up to one 128-byte physical row; int8 only below 64-byte
        rows; never for the rowwise layout."""
        if self.table_pack != 0:
            return max(1, self.table_pack)
        if self.table_quant == "int8_rowwise":
            return 1
        itemsize = (1 if self.table_quant == "int8"
                    else 2 if self.param_dtype == "bfloat16" else 4)
        row_bytes = self.sparse_feature_size * itemsize
        if self.table_quant == "int8" and row_bytes >= 64:
            return 1
        return max(1, 128 // row_bytes)

    @property
    def hotcold_auto_excluded(self) -> bool:
        """Retired in the JAX package and always False (JAX
        ``config.py:217``): ``embedding_impl="auto"`` is guarded against no
        table layout."""
        return False

    @property
    def dense_dim(self) -> int:
        """Width of the dense-feature input: DLRM's first bottom-MLP dim,
        WnD/MT-WnD's raw dense concat; NCF/DIN/DIEN take none."""
        if self.model_type in ("dlrm", "wnd", "mtwnd"):
            return self.mlp_bot[0]
        return 0

    @property
    def num_fea(self) -> int:
        return self.num_tables + 1

    @property
    def top_in_dim(self) -> int:
        """First dim of the top MLP, per reference num_int computations."""
        m = self.sparse_feature_size
        if self.model_type == "dlrm":
            # dlrm_s_caffe2.py:404-426
            if self.interaction_op == "dot":
                f = self.num_fea
                pairs = (f * (f + 1)) // 2 if self.interaction_itself else (f * (f - 1)) // 2
                return pairs + self.mlp_bot[-1]
            return self.num_fea * self.mlp_bot[-1]
        if self.model_type in ("wnd", "mtwnd"):
            return self.num_tables * m + self.mlp_bot[0]
        if self.model_type == "ncf":
            return 2 * m
        if self.model_type == "din":
            return 4 * m  # concat[profile, attention, ad, context]
        if self.model_type == "dien":
            return self.hidden_size + 3 * m
        raise AssertionError(self.model_type)

    @property
    def ln_top(self) -> tuple[int, ...]:
        return (self.top_in_dim,) + self.mlp_top

    @property
    def out_dim(self) -> int:
        if self.model_type == "mtwnd":
            return self.mlp_tasks[-1] * self.num_multi_tasks
        return self.mlp_top[-1]

    @property
    def behavior_table_ids(self) -> range:
        """DIN/DIEN behavior tables (din.py:295-300, dien.py:393-398)."""
        return range(1, self.num_tables - 2)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _expand_din_tables(rows: tuple[int, ...], user_behavior_tables: int) -> tuple[int, ...]:
    """[profile, behavior, ad, ctx] -> [profile] + [behavior]*(n+1) + [ad, ctx]
    (reference ``utils/utils.py:132-149``: n copies in front of the original)."""
    profile, behavior, rest = rows[0], rows[1], rows[2:]
    return (profile,) + (behavior,) * (user_behavior_tables + 1) + rest


def load_model_config(path: str | Path, table_scale: int = 1, **overrides) -> ModelConfig:
    """A model config from a reference-format JSON file
    (``models/configs/*.json`` keys)."""
    with open(path) as f:
        raw = json.load(f)
    return model_config_from_dict(raw, table_scale=table_scale, **overrides)


def model_config_from_dict(raw: dict, table_scale: int = 1, **overrides) -> ModelConfig:
    key_map = {
        "arch_mlp_bot": ("mlp_bot", _parse_dims),
        "arch_mlp_top": ("mlp_top", _parse_dims),
        "arch_mlp_tasks": ("mlp_tasks", _parse_dims),
        "arch_embedding_size": ("embedding_rows", _parse_dims),
        "arch_sparse_feature_size": ("sparse_feature_size", int),
        "arch_interaction_op": ("interaction_op", str),
        "arch_interaction_itself": ("interaction_itself", bool),
        "num_indices_per_lookup": ("num_indices_per_lookup", int),
        "num_indices_per_lookup_fixed": (None, None),  # implied; dense (B,T,L)
        "model_type": ("model_type", str),
        "model_name": ("model_name", str),
        "user_behavior_tables": ("user_behavior_tables", int),
        "hidden_size": ("hidden_size", int),
        "num_multi_tasks": ("num_multi_tasks", int),
    }
    kw: dict = {}
    for key, val in raw.items():
        if key not in key_map:
            raise KeyError(f"unknown config key {key!r}")
        field, conv = key_map[key]
        if field is not None:
            kw[field] = conv(val)
    kw.update(overrides)
    kw.setdefault("table_scale", table_scale)
    cfg = ModelConfig(**kw)
    if cfg.model_type == "din" and len(cfg.embedding_rows) == 4:
        cfg = cfg.replace(
            embedding_rows=_expand_din_tables(cfg.embedding_rows, cfg.user_behavior_tables))
    return cfg


@dataclasses.dataclass
class ServingConfig:
    """Load-generation, engine and scheduler knobs (reference serving
    flags, ``utils/utils.py:44-94``); times in milliseconds.

    One stated difference from the JAX package's: ``engine_backend`` is
    ``"gpu"`` (engines on the CUDA card, the default; raises without a
    card), ``"cpu"``, ``"cpu-mp"`` (CPU engine processes over shared-memory
    rings; ``payload_arena_slots`` sizes their payload arena) or ``"sim"``;
    ``"tpu"`` is refused."""

    # Query stream (loadGenerator.py:14-43)
    num_batches: int = 64
    nepochs: int = 1
    avg_arrival_rate_ms: float = 10.0
    batch_size_distribution: str = "fixed"  # fixed|normal|lognormal|file
    avg_mini_batch_size: float = 1.0
    var_mini_batch_size: float = 1.0
    max_mini_batch_size: int = 1024
    batch_dist_file: str | None = None
    sub_task_batch_size: int = 16

    # Engines and their batch buckets
    inference_engines: int = 1
    engine_backend: str = "gpu"
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    bucket_policy: str = "static"  # "static" | "auto" (serving/buckets.py)
    max_auto_buckets: int = 6

    # Tail-latency scheduler (scheduler.py, utils.py:69-85)
    target_latency_ms: float = 10.0
    req_granularity: int = 64
    tune_batch_qps: bool = False
    tune_accel_qps: bool = False
    batch_configs: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    accel_configs: tuple[int, ...] = (128, 256, 512)
    stable_region: float = 0.10
    min_arr_range: float = 1.0
    max_arr_range: float = 100.0
    arr_steps: int = 20
    sched_timeout: int = 100

    coalesce_requests: bool = False
    max_coalesce: int = 8

    # Big-query offload (utils.py:90-94)
    model_accel: bool = False
    accel_request_size_thres: int = 1024

    data_generation: str = "random"
    synthetic_trace_file: str | None = None
    raw_data_file: str | None = None

    hotcold_refresh_interval: int = 0
    hotcold_refresh_margin: float = 0.05
    hotcold_refresh_window: int = 16
    hotcold_scan_budget: int = 2_000_000
    hotcold_scan_async: bool = True

    accept_ragged: bool = False
    payload_arena_slots: int = 256

    seed: int = 123
    debug_mode: bool = False
    log_file: str | None = None

    def __post_init__(self):
        if self.engine_backend == "tpu":
            raise ValueError("engine_backend='tpu' is the JAX package's; the port "
                             "serves on 'gpu' (the CUDA card), 'cpu', 'cpu-mp' or 'sim'")
        if self.engine_backend not in ("gpu", "cpu", "cpu-mp", "sim"):
            raise ValueError(f"unknown engine_backend {self.engine_backend!r}")
        if self.hotcold_refresh_interval > 0 and self.hotcold_refresh_window < 2:
            raise ValueError(
                f"hotcold_refresh_window must be >= 2 when refresh tracking "
                f"is on; got {self.hotcold_refresh_window}")
        if self.payload_arena_slots < 1:
            raise ValueError(
                f"payload_arena_slots must be >= 1; got "
                f"{self.payload_arena_slots}")
