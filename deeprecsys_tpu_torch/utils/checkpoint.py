"""Parameter checkpoints in the JAX package's file format.

Counterpart of ``deeprecsys_tpu/utils/checkpoint.py:19-85``: a checkpoint
``<name>`` is ``<name>.npz``, the leaves as ``arr_0, arr_1, ...`` in JAX's
flatten order (dict keys sorted, lists in order), and ``<name>.tree.json``,
``{"treedef": str(PyTreeDef), "num_leaves": n}``, whose treedef string is
the one JAX writes (``treedef_str`` formats it). A checkpoint written by
either package loads in the other under the same config.

What is written is the tree given, in the JAX layout: the trainer and CLI
pass ``bridge.params_to_numpy(params, cfg)``, so a float table is
``{"packed": ...}`` where ``cfg`` resolves to pack > 1 (as the JAX dense
trainer keeps it) and per-table int8 exports are ``{"q_packed", "scale"}``;
the CLI's f32 d = 32/64 tables resolve to pack 1 and are written as they
are. bf16 leaves are written as ``ml_dtypes.bfloat16`` arrays, which
``np.savez`` stores as 2-byte void (``V2``): this loader reads them back by
their bit patterns. (The JAX package's own ``load_params`` cannot cast a
``V2`` leaf, so it refuses bf16 checkpoints of either package.)

``load_params`` validates the sidecar's treedef, the leaf count and every
shape against a template (``bridge.param_shapes`` for a model), with no
fallback for dotted names; ``load_model_params`` returns the numpy tree,
``checkpoint_params`` the port's tensors for serving.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from deeprecsys_tpu_torch import bridge


def _files(path: Path) -> tuple[Path, Path]:
    """Artifact paths for a checkpoint name. Suffixes are APPENDED: a
    ``with_suffix`` would collapse dotted names (ckpt.v1 and ckpt.v2 both
    to ckpt.npz)."""
    name = str(path)
    npz = Path(name if name.endswith(".npz") else name + ".npz")
    return npz, Path(name + ".tree.json")


def tree_flatten(tree) -> list:
    """The leaves of nested dicts, lists and tuples in JAX's order: dict
    keys sorted, sequences in order; None holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for nested dicts, lists,
    tuples and None, e.g. ``PyTreeDef({'bot': [{'b': *, 'w': *}], 'tables': *})``."""
    def fmt(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "None" if node is None else "*"

    return f"PyTreeDef({fmt(tree)})"


def _host(leaf) -> np.ndarray:
    return bridge._to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_params(path: str | Path, params) -> None:
    """Write ``params`` (numpy arrays or tensors, in the JAX layout) as
    ``<path>.npz`` plus the ``<path>.tree.json`` sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = [_host(leaf) for leaf in tree_flatten(params)]
    npz, sidecar = _files(path)
    np.savez(npz, *leaves)
    sidecar.write_text(json.dumps({"treedef": treedef_str(params),
                                   "num_leaves": len(leaves)}))


def _shape_dtype(leaf) -> tuple[tuple, np.dtype]:
    if isinstance(leaf, bridge.Leaf):
        return tuple(leaf.shape), _np_dtype(leaf.dtype)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _host(torch.empty(0, dtype=leaf.dtype)).dtype
    return tuple(leaf.shape), leaf.dtype


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def load_params(path: str | Path, like):
    """Restore into the structure of ``like`` (a template of numpy arrays,
    tensors or ``bridge.Leaf``s). The sidecar's treedef (when present), the
    leaf count and every leaf's shape must match ``like``'s; each leaf is
    cast to the template's dtype. Returns numpy arrays."""
    path = Path(path)
    npz, sidecar = _files(path)
    if not npz.exists():
        hint = ""
        if path.suffix and path.with_suffix(".npz").exists():
            hint = (f" (a save under an older naming scheme collapsed a dotted name onto "
                    f"{path.with_suffix('.npz')}; identify and re-save it)")
        raise FileNotFoundError(f"no checkpoint at {npz}{hint}")
    with np.load(npz) as data:
        loaded = [data[k] for k in data.files]
    want_def = treedef_str(like)
    if sidecar.exists():
        meta = json.loads(sidecar.read_text())
        if meta.get("treedef") not in (None, want_def):
            raise ValueError(
                f"checkpoint tree structure does not match the target "
                f"model:\n  saved:  {meta['treedef']}\n  target: {want_def}")
    like_leaves = tree_flatten(like)
    if len(loaded) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(loaded)} leaves, expected {len(like_leaves)}")
    out = []
    for got, want in zip(loaded, like_leaves):
        shape, dtype = _shape_dtype(want)
        if tuple(got.shape) != shape:
            raise ValueError(f"leaf shape mismatch: {got.shape} vs {shape}")
        if got.dtype.kind == "V" and got.dtype.itemsize == dtype.itemsize:
            got = got.view(dtype)  # a bf16 leaf, stored by its bit patterns
        out.append(got.astype(dtype))
    return tree_unflatten(like, out)


def load_model_params(model_cfg, path: str | Path) -> dict:
    """A checkpoint as a numpy params tree, validated against
    ``model_cfg``'s param shapes (no random init)."""
    return load_params(path, bridge.param_shapes(model_cfg))


def checkpoint_params(model_cfg, path: str | Path, device) -> dict:
    """A float checkpoint as the port's tensors on ``device``, for serving.
    A quantized config raises: the port does not serve int8 tables yet."""
    if model_cfg.table_quant != "none":
        raise NotImplementedError(
            f"serving a quantized checkpoint (table_quant={model_cfg.table_quant!r}) is not "
            "ported yet (ROADMAP.md Queue 1 item 8, quantized tables)")
    return bridge.params_from_numpy(load_model_params(model_cfg, path), model_cfg, device)
