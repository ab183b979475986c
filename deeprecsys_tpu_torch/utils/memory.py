"""Memory sizing of model configurations.

Counterpart of ``deeprecsys_tpu/utils/memory.py`` (:17-83):
``model_memory_bytes`` (parameter bytes by component, by the table's
layout), ``fits_hbm`` and ``suggest_hot_rows``, held equal to the originals
by ``tests/test_torch_hotcold.py``.

``suggest_hot_rows`` keeps the JAX package's 8 MB default budget, which was
sized for half of a TPU v5e core's 16 MB of VMEM, software-managed memory
that an H100 does not have (its 50 MB L2 caches hot rows on its own). It
stays, so that ``hot_set_rows=0`` sizes the same hot set as the JAX package
(131,072 rows for rm1 in bf16, 262,144 with ``int8`` tables, 233,016 with
``int8_rowwise``) and ``embedding_impl="auto"`` decides the same. What the
budget should be on an H100 is a question for a measurement (PERF.md), not
a default to change here.
"""

from __future__ import annotations

from deeprecsys_tpu_torch.config import ModelConfig

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def model_memory_bytes(cfg: ModelConfig) -> dict:
    """Parameter memory by component, in bytes, honoring table_quant."""
    d = cfg.sparse_feature_size
    if cfg.table_quant == "int8":
        table_bytes = cfg.total_rows * d * 1 + cfg.num_tables * 4  # + scales
    elif cfg.table_quant == "int8_rowwise":
        table_bytes = cfg.total_rows * (d + 4)  # the row's scale in its last 4 bytes
    else:
        table_bytes = cfg.total_rows * d * _DTYPE_BYTES[cfg.param_dtype]

    def mlp_bytes(dims):
        total = 0
        for i in range(1, len(dims)):
            total += (dims[i - 1] * dims[i] + dims[i]) * _DTYPE_BYTES[cfg.param_dtype]
        return total

    dense_bytes = 0
    if cfg.model_type == "dlrm":
        dense_bytes = mlp_bytes(cfg.mlp_bot) + mlp_bytes(cfg.ln_top)
    elif cfg.model_type == "wnd":
        dense_bytes = mlp_bytes(cfg.ln_top)
    elif cfg.model_type == "mtwnd":
        dense_bytes = mlp_bytes(cfg.ln_top) + cfg.num_multi_tasks * mlp_bytes(cfg.mlp_tasks)
    elif cfg.model_type == "ncf":
        dense_bytes = mlp_bytes(cfg.ln_top[:-1]) + mlp_bytes(
            (cfg.sparse_feature_size + cfg.ln_top[-2], cfg.ln_top[-1]))
    elif cfg.model_type == "din":
        att = (3 * d,) + cfg.mlp_bot + (d,)
        dense_bytes = len(list(cfg.behavior_table_ids)) * mlp_bytes(att) + mlp_bytes(cfg.ln_top)
    elif cfg.model_type == "dien":
        H = cfg.hidden_size
        # rnn0: input d -> H; rnn1: input H -> H (each has i2h w+b, h2h w+b)
        rnn = ((d * H + H + H * H + H) + (H * H + H + H * H + H)) * _DTYPE_BYTES[cfg.param_dtype]
        dense_bytes = rnn + mlp_bytes((H, H)) + mlp_bytes(cfg.ln_top)
    return {
        "tables_bytes": int(table_bytes),
        "dense_bytes": int(dense_bytes),
        "total_bytes": int(table_bytes + dense_bytes),
    }


def fits_hbm(cfg: ModelConfig, hbm_bytes: int = 16 * 2**30, n_model_shards: int = 1,
             activation_reserve: float = 0.15) -> bool:
    """Whether the parameters fit a device's memory with a reserve for
    activations; tables divide over the model axis. The default is the JAX
    package's (a 16 GiB TPU core); pass 80 * 2**30 for an H100."""
    m = model_memory_bytes(cfg)
    per_chip = m["tables_bytes"] / n_model_shards + m["dense_bytes"]
    return per_chip <= hbm_bytes * (1 - activation_reserve)


def suggest_hot_rows(cfg: ModelConfig, vmem_budget_bytes: int = 8 * 2**20) -> int:
    """The hot-set size for ``hot_set_rows=0``: the rows of the table's
    layout that fit the budget (d * dtype bytes, d for int8, d + 4 for
    row-wise), at least 1 and at most the table. The 8 MB default is the
    JAX package's (see the module docstring)."""
    d = cfg.sparse_feature_size
    if cfg.table_quant == "int8":
        row_bytes = d
    elif cfg.table_quant == "int8_rowwise":
        row_bytes = d + 4
    else:
        row_bytes = d * _DTYPE_BYTES[cfg.param_dtype]
    return max(1, min(int(vmem_budget_bytes // row_bytes), cfg.total_rows))
