"""Weights across the two packages.

``params_from_numpy`` maps a JAX params pytree, held as numpy arrays
(``jax.device_get(params)``), to the port's tensors; ``params_to_numpy``
maps them back. The layout is the same on both sides (nested dicts and
lists: MLP layers ``{"w", "b"}`` with ``w`` as ``(in, out)``, stacked MLPs
``(num, in, out)``, RNNs ``{"i2h_w", ...}``) except for the fused table:
the JAX package may store it packed, ``{"packed": (ceil(R/p), p*d)}``
(bf16 d=32 resolves to p=2, ``config.py:193-214``); the port keeps
``(R, d)``. Quantized tables cross too: ``{"qrows": (R, d+4) int8}`` as it
is, per-table int8 as the port's ``{"q": (R, d), "scale": (T,)}`` and,
where the config resolves to pack > 1, the JAX package's ``{"q_packed",
"scale"}``; ``models/base.py::pooled_lookup`` serves both.

``init_numpy`` draws a model's whole params pytree with numpy from a seed,
in the JAX layout and with the JAX init's distributions, so that both
packages, and a machine without JAX, can build the same weights;
``param_shapes`` gives the same tree's leaf shapes and dtypes without
drawing (the template a checkpoint is loaded against).
``flatten``/``unflatten`` map a pytree to flat ``"a/0/w"`` keys (an
``.npz``'s) and back.

bfloat16 arrays on the numpy side are ``ml_dtypes.bfloat16``; they cross
by their 16-bit patterns, so no value changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.ops.embedding import int8_table_scales, unpack_table


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A leaf of ``param_shapes``: its shape and numpy dtype name."""

    shape: tuple
    dtype: str


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict:
    """Flat ``{"a/0/w": leaf}`` keys for a pytree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def fingerprint(tree) -> np.ndarray:
    """The float64 sum of each numpy leaf, in ``flatten`` order: a cheap
    check that two machines drew the same ``init_numpy`` weights."""
    return np.array([np.asarray(v, np.float64).sum() for v in flatten(tree).values()])


def unflatten(flat) -> dict:
    """The pytree for flat ``"a/0/w"`` keys (inverse of ``flatten``): a
    node whose keys are all digits becomes a list, any other a dict."""
    root: dict = {}
    for key in flat:
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = flat[key]
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_numpy(np_params: dict, cfg: ModelConfig,
                      device: torch.device | str) -> dict:
    """The port's params for a JAX params pytree of numpy arrays: packed
    tables (``packed``, ``q_packed``) unpacked to ``(R, d)`` rows."""
    params = {k: tree_map(lambda a: _to_tensor(a, device), v)
              for k, v in np_params.items() if k != "tables"}
    tables = np_params["tables"]
    d, R = cfg.sparse_feature_size, cfg.total_rows
    if not isinstance(tables, dict):
        params["tables"] = _to_tensor(tables, device)
    elif "packed" in tables or "q_packed" in tables:
        key = "packed" if "packed" in tables else "q_packed"
        packed = tables[key]
        # unpack_table's slice of a contiguous tensor is contiguous.
        t = unpack_table(_to_tensor(packed, device), packed.shape[1] // d, R)
        params["tables"] = t if key == "packed" else {
            "q": t, "scale": _to_tensor(tables["scale"], device)}
    else:
        params["tables"] = {k: _to_tensor(v, device) for k, v in tables.items()}
    return params


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The JAX params pytree (numpy arrays) for the port's params, with the
    table in the layout the JAX package resolves for ``cfg`` (packed where
    the resolved pack factor is > 1; ``q_packed`` for per-table int8)."""
    out = {k: tree_map(_to_numpy, v) for k, v in params.items() if k != "tables"}
    tables = params["tables"]
    if not isinstance(tables, dict):
        out["tables"] = _pack(_to_numpy(tables), cfg)
    elif "q" in tables and cfg.resolved_table_pack > 1:
        out["tables"] = {"q_packed": _pack(_to_numpy(tables["q"]), cfg)["packed"],
                         "scale": _to_numpy(tables["scale"])}
    else:
        out["tables"] = {k: _to_numpy(v) for k, v in tables.items()}
    return out


def _pack(table: np.ndarray, cfg: ModelConfig):
    """``table`` in the JAX package's layout for ``cfg``: ``{"packed"}``
    with zero pad rows when the resolved pack factor is > 1."""
    pack = cfg.resolved_table_pack
    if pack <= 1:
        return table
    rows, d = table.shape
    table = np.concatenate([table, np.zeros((-rows % pack, d), table.dtype)])
    return {"packed": table.reshape(-1, pack * d)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The JAX params pytree of ``cfg``'s model with ``Leaf`` leaves:
    ``init_numpy``'s tree (for int8 tables, the JAX init's quantized
    layout), nothing drawn."""
    pdt = cfg.param_dtype
    m, H, ln_top = cfg.sparse_feature_size, cfg.hidden_size, cfg.ln_top

    def mlp(dims, num=None):
        lead = () if num is None else (num,)
        return [{"w": Leaf(lead + (n, o), pdt), "b": Leaf(lead + (o,), pdt)}
                for n, o in zip(dims[:-1], dims[1:])]

    def rnn(n):
        return {"i2h_w": Leaf((n, H), pdt), "i2h_b": Leaf((H,), pdt),
                "h2h_w": Leaf((H, H), pdt), "h2h_b": Leaf((H,), pdt)}

    kind = cfg.model_type
    if kind == "dlrm":
        tree = {"bot": mlp(cfg.mlp_bot), "top": mlp(ln_top)}
    elif kind == "wnd":
        tree = {"top": mlp(ln_top)}
    elif kind == "mtwnd":
        tree = {"top": mlp(ln_top), "tasks": mlp(cfg.mlp_tasks, num=cfg.num_multi_tasks)}
    elif kind == "ncf":
        tree = {"mlp": mlp(ln_top[:-1]), "final": mlp((m + ln_top[-2], ln_top[-1]))}
    elif kind == "din":
        nb = len(cfg.behavior_table_ids)
        tree = {"attention": mlp((3 * m,) + cfg.mlp_bot + (m,), num=nb), "top": mlp(ln_top)}
    elif kind == "dien":
        tree = {"rnn0": rnn(m), "gate_fc": mlp((H, H))[0], "rnn1": rnn(H), "top": mlp(ln_top)}
    else:
        raise ValueError(f"unknown model_type {kind!r}")
    R, pack = cfg.total_rows, cfg.resolved_table_pack
    packed = (-(-R // pack), pack * m)
    if cfg.table_quant == "int8_rowwise":
        tables = {"qrows": Leaf((R, m + 4), "int8")}
    elif cfg.table_quant == "int8":
        tables = {"q_packed" if pack > 1 else "q": Leaf(packed if pack > 1 else (R, m), "int8"),
                  "scale": Leaf((cfg.num_tables,), "float32")}
    elif cfg.table_quant == "none":
        tables = {"packed": Leaf(packed, pdt)} if pack > 1 else Leaf((R, m), pdt)
    else:
        raise ValueError(f"unknown table_quant {cfg.table_quant!r}")
    tree["tables"] = tables
    return tree


# ------------------------------------------------------------ numpy init

def _np_mlp(rng: np.random.Generator, dims, num: int | None = None,
            sum_fanin: int = 1) -> list[dict]:
    """``mlp_init`` (``num`` None) or ``stacked_mlp_init``: w ~ N(0,
    sqrt(2/(n+m))), b ~ N(0, sqrt(1/m)); the last layer over sqrt(sum_fanin)."""
    lead = () if num is None else (num,)
    layers = []
    for i, (n, m) in enumerate(zip(dims[:-1], dims[1:]), start=1):
        w = rng.standard_normal(lead + (n, m), dtype=np.float32) * np.float32(np.sqrt(2.0 / (m + n)))
        b = rng.standard_normal(lead + (m,), dtype=np.float32) * np.float32(np.sqrt(1.0 / m))
        if sum_fanin > 1 and i == len(dims) - 1:
            s = np.float32(1.0 / np.sqrt(sum_fanin))
            w, b = w * s, b * s
        layers.append({"w": w, "b": b})
    return layers


def _np_rnn(rng: np.random.Generator, n: int, H: int) -> dict:
    """``basic_rnn_init``: 1/sqrt(fan_in)-scaled N(0, 1) weights, zero biases."""
    def weight(fan_in, m):
        return rng.standard_normal((fan_in, m), dtype=np.float32) / np.float32(np.sqrt(fan_in))

    return {"i2h_w": weight(n, H), "i2h_b": np.zeros((H,), np.float32),
            "h2h_w": weight(H, H), "h2h_b": np.zeros((H,), np.float32)}


def _np_tables(rng: np.random.Generator, cfg: ModelConfig) -> np.ndarray:
    """The fused ``(total_rows, d)`` table, table t ~ U(-sqrt(1/n_t), sqrt(1/n_t))."""
    d = cfg.sparse_feature_size
    parts = [(rng.random((n, d), dtype=np.float32) * 2 - 1) * np.float32(np.sqrt(1.0 / n))
             for n in cfg.scaled_rows]
    return np.concatenate(parts)


def _np_tables_int8(rng: np.random.Generator, cfg: ModelConfig):
    """The int8 inits' values, ``(total_rows, d)`` drawn uniformly from
    [-127, 127], and their ``(T,)`` per-table scales (the division the JAX
    inits make, ``ops/embedding.py::int8_table_scales``)."""
    d = cfg.sparse_feature_size
    q = np.concatenate([rng.integers(-127, 127, (n, d), dtype=np.int8, endpoint=True)
                        for n in cfg.scaled_rows])
    return q, int8_table_scales(cfg.scaled_rows)


def _table_layout(tables, cfg: ModelConfig):
    """The drawn table in the JAX init's layout for ``cfg``: float tables
    packed where the config resolves to pack > 1; ``{"q" or "q_packed",
    "scale"}``; ``{"qrows"}`` with each row's table scale as its last 4
    (little-endian) bytes."""
    if cfg.table_quant == "none":
        return _pack(tables, cfg)
    q, scale = tables
    if cfg.table_quant == "int8_rowwise":
        row_scale = np.repeat(scale, cfg.scaled_rows)
        return {"qrows": np.concatenate([q, row_scale.view(np.int8).reshape(-1, 4)], axis=1)}
    if cfg.table_quant != "int8":
        raise ValueError(f"unknown table_quant {cfg.table_quant!r}")
    if cfg.resolved_table_pack > 1:
        return {"q_packed": _pack(q, cfg)["packed"], "scale": scale}
    return {"q": q, "scale": scale}


def init_numpy(cfg: ModelConfig, seed: int) -> dict:
    """The JAX params pytree of ``cfg``'s model, drawn with numpy from
    ``seed``: the same keys, shapes, dtypes and table layout as the JAX
    ``init``, and its distributions (not its values: JAX's PRNG differs).
    Every float leaf is drawn in f32 and cast to the param dtype, so a bf16
    tree is exactly the f32 tree of the same seed, cast; int8 tables stay
    int8 with f32 scales (``q_packed`` where the config resolves to pack >
    1, as in the JAX init)."""
    rng = np.random.default_rng(seed)
    m, H, ln_top = cfg.sparse_feature_size, cfg.hidden_size, cfg.ln_top
    quantized = cfg.table_quant != "none"
    tables = _np_tables_int8(rng, cfg) if quantized else _np_tables(rng, cfg)
    tree: dict = {}
    kind = cfg.model_type
    if kind == "dlrm":
        tree.update(bot=_np_mlp(rng, cfg.mlp_bot), top=_np_mlp(rng, ln_top))
    elif kind == "wnd":
        tree.update(top=_np_mlp(rng, ln_top))
    elif kind == "mtwnd":
        tree.update(top=_np_mlp(rng, ln_top),
                    tasks=_np_mlp(rng, cfg.mlp_tasks, num=cfg.num_multi_tasks))
    elif kind == "ncf":
        tree.update(mlp=_np_mlp(rng, ln_top[:-1]),
                    final=_np_mlp(rng, (m + ln_top[-2], ln_top[-1])))
    elif kind == "din":
        nb = len(cfg.behavior_table_ids)
        tree.update(attention=_np_mlp(rng, (3 * m,) + cfg.mlp_bot + (m,), num=nb, sum_fanin=nb),
                    top=_np_mlp(rng, ln_top))
    elif kind == "dien":
        tree.update(rnn0=_np_rnn(rng, m, H), gate_fc=_np_mlp(rng, (H, H))[0],
                    rnn1=_np_rnn(rng, H, H), top=_np_mlp(rng, ln_top))
    else:
        raise ValueError(f"unknown model_type {kind!r}")
    if cfg.param_dtype == "bfloat16":
        import ml_dtypes

        tree = tree_map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
        tables = tables if quantized else tables.astype(ml_dtypes.bfloat16)
    elif cfg.param_dtype != "float32":
        raise ValueError(f"unsupported param_dtype {cfg.param_dtype!r}")
    # "tables" first: fingerprint() reads the leaves in this order.
    return {"tables": _table_layout(tables, cfg), **tree}
