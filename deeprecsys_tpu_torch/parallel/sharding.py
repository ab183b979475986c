"""Sharded serving over a ``Mesh`` (counterpart of
``deeprecsys_tpu/parallel/sharding.py``), and the training losses.

The JAX package states its parallelism as shardings on one jitted
function and lets GSPMD insert the collectives. The port makes every step
explicit, from the calling thread:

- ``shard_params``: the fused table is row-sharded over "model" (shard m,
  rows ``[m * R/M, (m+1) * R/M)``, lives on every entry of column m) and
  every other leaf is replicated. Each mesh entry gets its own params dict
  (``ShardedParams.entry(d, m)``); entries that name the same device share
  one tensor a (device, shard), so a 2x2 mesh of one card holds the table
  once. A shard of a table already on its device is a view of it, no copy.
- a lookup: each shard pools its own partial with the ownership window
  (``ops/embedding.py::embedding_bag_shard`` and its int8 siblings, K1,
  K1-int8 and K4), in the type the single-device kernel sums in: f32 for
  float and row-wise tables, the exact int32 pool for per-table int8.
- the combine (the JAX ``psum`` over "model"): the partials are moved to the
  row's first entry with ``.to(device, non_blocking=True)`` and added in
  shard order; then the scale (int8) and the cast to the compute dtype,
  once. A sharded per-table int8 lookup is therefore bit for bit the
  single-device K1-int8; a float or row-wise one differs from the
  single-device lookup only in the order of its f32 sums.
- the batch splits over "data" into D contiguous slices; slice d looks up on
  row d of the mesh and runs the model's ``apply_from_pooled`` on entry
  (d, 0); the slices' scores are concatenated on ``mesh.devices.flat[0]``.

Each launch goes to the current stream of its entry's device. A partial
moved between two devices is ordered by PyTorch's cross-device copy, which
waits on the current streams of both; on one device everything is on one
stream. The CPU tests can check the combine's order only as far as one
device shows it: the order across several cards is untested.

Table-wise sharding (``build_tablewise_tables``, ``tablewise_embedding_bag``)
places whole tables on shards (``placement.py``); each shard pools its own
tables with the direct kernels and the combine is a ``torch.cat`` (the JAX
``all_gather``), then the inverse permutation. The hot/cold lookups over a
mesh run K6 on each shard's cold stream (``sharded_embedding_bag_hotcold``:
tensor-parallel, the batch on row 0; ``hybrid_embedding_bag_hotcold``: a
cold stream a (data, model) cell).

The sharded trainers (``make_train_step``) are not ported yet (ROADMAP.md
Queue 1 item 12b). The losses at the end are the JAX module's (:427-462).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import Batch, ModelFns, compute_dtype_of
from deeprecsys_tpu_torch.parallel.mesh import Mesh

# ----------------------------------------------------------------------
# Placing tensors on a mesh
# ----------------------------------------------------------------------


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself if it is there), copied to a card
    asynchronously (from pinned host memory or another card; a copy to the
    host waits for the data)."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=device.type == "cuda")


class Sharded:
    """A tensor split over the mesh's "model" axis: ``part(d, m)`` is
    shard m on entry (d, m); one tensor a distinct (device, shard)."""

    def __init__(self, mesh: Mesh, parts: list):
        self.mesh = mesh
        self.parts = parts  # [d][m]

    @classmethod
    def place(cls, mesh: Mesh, shard_of: Callable[[int], torch.Tensor]) -> "Sharded":
        cache: dict = {}
        parts = []
        for d in range(mesh.shape["data"]):
            row = []
            for m in range(mesh.shape["model"]):
                dev = mesh.device(d, m)
                key = (dev, m)
                if key not in cache:
                    cache[key] = _to(shard_of(m), dev).contiguous()
                row.append(cache[key])
            parts.append(row)
        return cls(mesh, parts)

    @classmethod
    def rows(cls, table: torch.Tensor, mesh: Mesh) -> "Sharded":
        """``table``'s rows in M equal shards (M must divide them)."""
        M = mesh.shape["model"]
        if table.shape[0] % M:
            raise ValueError(f"{table.shape[0]} rows do not divide over model axis {M}")
        rps = table.shape[0] // M
        return cls.place(mesh, lambda m: table[m * rps:(m + 1) * rps])

    @classmethod
    def stacked(cls, tables: torch.Tensor, mesh: Mesh) -> "Sharded":
        """Shard m is ``tables[m]`` (a leading axis of M shards)."""
        if tables.shape[0] != mesh.shape["model"]:
            raise ValueError(f"{tables.shape[0]} shards for model axis {mesh.shape['model']}")
        return cls.place(mesh, lambda m: tables[m])

    def part(self, d: int, m: int) -> torch.Tensor:
        return self.parts[d][m]

    @property
    def rows_per_shard(self) -> int:
        return int(self.parts[0][0].shape[0])


class Replicated:
    """One copy of a tensor on each distinct device of a mesh."""

    def __init__(self, mesh: Mesh, t: torch.Tensor):
        self.mesh = mesh
        self.copies = {dev: _to(t, dev) for dev in mesh.distinct_devices}

    def on(self, device: torch.device) -> torch.Tensor:
        return self.copies[device]


# ----------------------------------------------------------------------
# Parameter and batch placement
# ----------------------------------------------------------------------


def _table_leaves(tables) -> dict:
    """The 2-D leaves of a table layout by key (a tensor: key None)."""
    if isinstance(tables, dict):
        return {k: v for k, v in tables.items() if v.dim() == 2}
    return {None: tables}


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """How ``shard_params`` places each leaf (JAX ``sharding.py:48-80``):
    ``"model"`` for a 2-D leaf of ``params["tables"]`` (a float table, the
    int8 ``q`` or the row-wise ``qrows``), row-sharded over the model axis,
    and ``"replicated"`` for everything else (the towers, the per-table
    ``scale``, a hot table). A table whose rows do not divide the model
    axis is replicated, with the JAX package's warning."""
    n_model = mesh.shape["model"]

    def spec(path, leaf):
        if path and path[0] == "tables" and leaf.dim() == 2:
            if leaf.shape[0] % n_model:
                print(f"[deeprecsys_tpu] WARNING: table with "
                      f"{leaf.shape[0]} physical rows does not divide "
                      f"the model axis ({n_model}); replicating it "
                      f"(pad rows or adjust table_pack to shard)",
                      flush=True)
                return "replicated"
            return "model"
        return "replicated"

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        return spec(path, tree)

    return walk(params, ())


class ShardedParams:
    """A model's params as each mesh entry holds them (``shard_params``).
    ``entry(d, m)`` is a params dict whose ``"tables"`` holds shard m of the
    table's layout (the whole table where it is replicated) and whose other
    leaves are the copies on entry (d, m)'s device. ``rows_per_shard`` is
    None where the table is replicated."""

    def __init__(self, mesh: Mesh, entries: list, rows_per_shard: int | None):
        self.mesh = mesh
        self.entries = entries  # [d][m]
        self.rows_per_shard = rows_per_shard

    def entry(self, d: int, m: int) -> dict:
        return self.entries[d][m]

    def with_leaf(self, key: str, t: torch.Tensor) -> "ShardedParams":
        """The same params with top-level leaf ``key`` replaced by ``t``,
        replicated: one copy a distinct device."""
        rep = Replicated(self.mesh, t)
        entries = [[{**e, key: rep.on(self.mesh.device(d, m))} for m, e in enumerate(row)]
                   for d, row in enumerate(self.entries)]
        return ShardedParams(self.mesh, entries, self.rows_per_shard)

    def tensors(self) -> list:
        """Every distinct tensor the entries hold."""
        from deeprecsys_tpu_torch.utils.checkpoint import tree_flatten

        seen: dict = {}
        for row in self.entries:
            for e in row:
                for t in tree_flatten(e):
                    seen.setdefault(id(t), t)
        return list(seen.values())


def gather_rows(sp: ShardedParams, ids) -> torch.Tensor:
    """Rows ``ids`` (sorted fused row ids) of the sharded table's 2-D leaf
    (the float table, the int8 ``q`` or the row-wise ``qrows``), as raw rows
    of that layout, on ``mesh.devices.flat[0]``: each shard gathers the rows
    it owns, never pooled (the mesh refresh's hot table, JAX
    ``engine.py:490-542``)."""
    mesh = sp.mesh
    dev0 = mesh.devices.flat[0]

    def leaf(e):
        t = e["tables"]
        return t if not isinstance(t, dict) else t["qrows"] if "qrows" in t else t["q"]

    ids = torch.as_tensor(np.asarray(ids, dtype=np.int64))
    if sp.rows_per_shard is None:
        return leaf(sp.entry(0, 0)).index_select(0, ids.to(dev0))
    table0 = leaf(sp.entry(0, 0))
    out = torch.empty((len(ids), table0.shape[1]), dtype=table0.dtype, device=dev0)
    owner = ids // sp.rows_per_shard
    for m in range(mesh.shape["model"]):
        pos = torch.nonzero(owner == m).flatten()
        if pos.numel():
            part = leaf(sp.entry(0, m))
            local = (ids[pos] - m * sp.rows_per_shard).to(part.device)
            out[pos.to(dev0)] = _to(part.index_select(0, local), dev0)
    return out


def shard_params(params: dict, mesh: Mesh) -> ShardedParams:
    """Place ``params`` on the mesh per ``param_shardings`` (JAX
    ``sharding.py:97-99``): one copy a distinct device of each replicated
    leaf, one tensor a (device, shard) of each sharded table leaf."""
    specs = param_shardings(params, mesh)
    D, M = mesh.shape["data"], mesh.shape["model"]
    tables = params["tables"]
    leaves = _table_leaves(tables)
    sharded = {k: Sharded.rows(v, mesh) for k, v in leaves.items()
               if (specs["tables"] if k is None else specs["tables"][k]) == "model"}
    rows_per_shard = next(iter(sharded.values())).rows_per_shard if sharded else None
    cache: dict = {}

    def copy_on(t, dev):
        key = (id(t), dev)
        if key not in cache:
            cache[key] = _to(t, dev)
        return cache[key]

    def rep(tree, dev):
        if isinstance(tree, dict):
            return {k: rep(v, dev) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rep(v, dev) for v in tree)
        return copy_on(tree, dev)

    entries = []
    for d in range(D):
        row = []
        for m in range(M):
            dev = mesh.device(d, m)
            e = {k: rep(v, dev) for k, v in params.items() if k != "tables"}
            if isinstance(tables, dict):
                e["tables"] = {k: (sharded[k].part(d, m) if k in sharded else copy_on(v, dev))
                               for k, v in tables.items()}
            else:
                e["tables"] = sharded[None].part(d, m) if None in sharded else copy_on(tables, dev)
            row.append(e)
        entries.append(row)
    return ShardedParams(mesh, entries, rows_per_shard)


def _slice_batch(batch: Batch, lo: int, hi: int) -> Batch:
    def cut(x):
        return None if x is None else x[lo:hi]

    return Batch(dense=cut(batch.dense), indices=cut(batch.indices), mask=cut(batch.mask))


def split_batch(batch: Batch, mesh: Mesh) -> list:
    """The batch's D contiguous slices over "data" (JAX ``batch_shardings``:
    every field, the mask too, shards over its first axis), as tensors (a
    host batch may hold numpy arrays); B must divide."""
    batch = Batch(*(None if x is None else torch.as_tensor(x) for x in batch))
    D = mesh.shape["data"]
    B = (batch.indices if batch.indices is not None else batch.dense).shape[0]
    if B % D:
        raise ValueError(f"batch {B} does not divide over data axis {D}")
    b = B // D
    return [_slice_batch(batch, d * b, (d + 1) * b) for d in range(D)]


def _batch_to(batch: Batch, device: torch.device) -> Batch:
    def conv(x):
        return None if x is None else _to(torch.as_tensor(x), device)

    return Batch(dense=conv(batch.dense), indices=conv(batch.indices), mask=conv(batch.mask))


def _combine(partials: list, device: torch.device) -> torch.Tensor:
    """The ``psum`` over "model": the partials moved to ``device`` and added
    in shard order."""
    acc = _to(partials[0], device)
    for p in partials[1:]:
        acc = acc + _to(p, device)
    return acc


# ----------------------------------------------------------------------
# Row-sharded lookups
# ----------------------------------------------------------------------


def shard_local_indices(indices: torch.Tensor, offsets: torch.Tensor, rows_per_shard: int,
                        shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Global per-table ``(B, T, L)`` ids as row shard ``shard``'s local
    rows (JAX ``sharding.py:102-115``, where the shard is
    ``axis_index("model")``): ``(safe, valid)``, the clamped local rows and
    the ownership mask. The rule is ``ops/embedding.py::window_ids``', which
    the kernels' plain versions read and the kernels fold into their row
    loads (``embedding_bag_shard``)."""
    from deeprecsys_tpu_torch.ops.embedding import window_ids

    row_lo = shard * rows_per_shard
    safe, valid = window_ids(offsets, indices, None, (row_lo, row_lo + rows_per_shard))
    return safe.reshape(indices.shape), valid


def masked_pooled_psum(table_shards: list, safe: list, valid: list, *,
                       compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Each shard's masked gather and L-pool, completed by the sum over the
    shards (JAX ``sharding.py:118-130``; non-owned rows add zeros): plain
    torch, in the compute dtype, on the first shard's device."""
    pooled = []
    for tbl, s, v in zip(table_shards, safe, valid):
        B, T, L = s.shape
        rows = tbl.index_select(0, s.reshape(-1).to(tbl.device))
        if compute_dtype is not None:
            rows = rows.to(compute_dtype)
        rows = rows.reshape(B, T, L, -1)
        rows = torch.where(v.to(tbl.device)[..., None], rows, torch.zeros((), dtype=rows.dtype))
        pooled.append(rows.sum(dim=2))
    return _combine(pooled, table_shards[0].device)


def _layout(tables) -> str:
    if not isinstance(tables, dict):
        return "float"
    if set(tables) == {"q", "scale"}:
        return "int8"
    if set(tables) == {"qrows"}:
        return "int8_rowwise"
    raise ValueError(f"unknown table layout {sorted(tables)} (the port takes a tensor, "
                     "{'q', 'scale'} or {'qrows'})")


def _finish(acc: torch.Tensor, layout: str, cdt: torch.dtype, scale=None) -> torch.Tensor:
    """The combined partials as the single-device kernel ends: a per-table
    int8 pool times its table's f32 scale (one multiply), then one cast."""
    if layout == "int8":
        return (acc.float() * scale.float()[None, :, None]).to(cdt)
    return acc.to(cdt)


def _shard_partial(layout: str, tables, offsets, indices, row_lo: int, cdt, mask):
    from deeprecsys_tpu_torch import ops

    if layout == "float":
        return ops.embedding_bag_shard(tables, offsets, indices, row_lo, compute_dtype=cdt,
                                       mask=mask)
    if layout == "int8":
        return ops.embedding_bag_int8_shard(tables["q"], offsets, indices, row_lo, mask=mask)
    return ops.embedding_bag_int8_rowwise_shard(tables["qrows"], offsets, indices, row_lo,
                                                mask=mask)


def _row_sharded_pooled(entry_tables: Callable, mesh: Mesh, d: int, rows_per_shard: int,
                        offsets: Replicated, indices, mask, cdt, layout: str, scale_on):
    """Row d's pooled lookup: a partial a shard (the window), combined on
    entry (d, 0), finished there."""
    out_dev = mesh.device(d, 0)
    moved: dict = {}
    partials = []
    for m in range(mesh.shape["model"]):
        dev = mesh.device(d, m)
        if dev not in moved:
            moved[dev] = (_to(indices, dev), None if mask is None else _to(mask, dev))
        idx, msk = moved[dev]
        partials.append(_shard_partial(layout, entry_tables(m), offsets.on(dev), idx,
                                       m * rows_per_shard, cdt, msk))
    return _finish(_combine(partials, out_dev), layout, cdt, scale_on(out_dev))


def sharded_embedding_bag(table, offsets: torch.Tensor, indices: torch.Tensor, mesh: Mesh,
                          total_rows: int, *, compute_dtype: torch.dtype | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup with the table row-sharded over "model" and the batch
    over "data" (JAX ``sharding.py:133-169``): ``table`` is the fused
    ``(total_rows, d)`` float table (sharded here) or its ``Sharded`` rows.
    Each shard pools the rows it owns (K1 with the window), one sum over the
    shards completes each data slice; returns ``(B, T, d)`` in the compute
    dtype on ``mesh.devices.flat[0]``. ``total_rows`` must divide over the
    model axis (``pad_rows_for_mesh``)."""
    n_model = mesh.shape["model"]
    if total_rows % n_model:
        raise ValueError(f"total rows {total_rows} must divide over model axis {n_model}; "
                         "pad the last table (see pad_rows_for_mesh)")
    rows = table if isinstance(table, Sharded) else Sharded.rows(table, mesh)
    cdt = compute_dtype if compute_dtype is not None else rows.part(0, 0).dtype
    offs = Replicated(mesh, offsets)
    out = []
    for d, sl in enumerate(split_batch(Batch(dense=None, indices=indices, mask=mask), mesh)):
        out.append(_row_sharded_pooled(lambda m, d=d: rows.part(d, m), mesh, d,
                                       total_rows // n_model, offs, sl.indices, sl.mask, cdt,
                                       "float", lambda dev: None))
    return torch.cat([_to(o, mesh.devices.flat[0]) for o in out], dim=0)


def pad_rows_for_mesh(cfg: ModelConfig, n_model: int) -> int:
    """Rows of padding needed so the fused table divides over the model axis."""
    r = cfg.total_rows % n_model
    return 0 if r == 0 else n_model - r


def _pooled_on_row(sp: ShardedParams, d: int, batch: Batch, cfg: ModelConfig,
                   offsets: Replicated) -> torch.Tensor:
    """Row d's pooled lookup for the table's layout, on entry (d, 0)."""
    from deeprecsys_tpu_torch.models.base import pooled_lookup

    mesh = sp.mesh
    dev0 = mesh.device(d, 0)
    tables0 = sp.entry(d, 0)["tables"]
    if sp.rows_per_shard is None:  # a replicated table: the direct lookup
        b = _batch_to(batch, dev0)
        return pooled_lookup(tables0, b, cfg, offsets=offsets.on(dev0))
    layout = _layout(tables0)
    return _row_sharded_pooled(
        lambda m: sp.entry(d, m)["tables"], mesh, d, sp.rows_per_shard, offsets, batch.indices,
        batch.mask, compute_dtype_of(cfg), layout,
        lambda dev: tables0["scale"] if layout == "int8" else None)


def sharded_apply(model: ModelFns, mesh: Mesh, has_dense: bool) -> Callable:
    """The model's forward over the mesh (JAX ``sharding.py:411-425``, which
    jits ``model.apply`` and leaves the collectives to GSPMD). The port
    takes the ``ModelFns`` (its ``apply_from_pooled``) and no params, and
    returns ``fn(sharded_params, batch) -> scores``: for each data slice,
    the row-sharded lookup of the table's layout (K1, K1-int8 or K4 with the
    window, combined, finished), then ``apply_from_pooled`` on entry (d, 0)
    (dien's K3 there too); the slices' scores concatenated on
    ``mesh.devices.flat[0]``. ``sharded_params`` is ``shard_params``' (placed
    once, not a call); the batch on any device (pinned host memory copies
    asynchronously)."""
    cfg = model.cfg
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))

    def fn(sp: ShardedParams, batch: Batch) -> torch.Tensor:
        if not isinstance(sp, ShardedParams):
            raise TypeError(f"sharded_apply's fn takes shard_params(params, mesh), not "
                            f"{type(sp).__name__}")
        if has_dense != (batch.dense is not None):
            raise ValueError(f"has_dense={has_dense} but the batch "
                             f"{'has no' if batch.dense is None else 'has'} dense features")
        scores = []
        for d, sl in enumerate(split_batch(batch, mesh)):
            pooled = _pooled_on_row(sp, d, sl, cfg, offsets)
            dev0 = mesh.device(d, 0)
            tail = Batch(dense=None if sl.dense is None else _to(torch.as_tensor(sl.dense), dev0),
                         indices=None, mask=None)
            scores.append(model.apply_from_pooled(sp.entry(d, 0), pooled, tail))
        out_dev = mesh.devices.flat[0]
        return torch.cat([_to(s, out_dev) for s in scores], dim=0)

    return fn


# ----------------------------------------------------------------------
# Hot/cold lookups over a mesh
# ----------------------------------------------------------------------


def _quant_layout(table_scale, rowwise: bool) -> str:
    return "int8_rowwise" if rowwise else "int8" if table_scale is not None else "float"


def _hotcold_shard_partial(layout: str, hot, shard, split: dict, cdt):
    from deeprecsys_tpu_torch import ops

    if layout == "float":
        return ops.embedding_bag_hotcold_shard(hot, shard, split, compute_dtype=cdt)
    if layout == "int8":
        return ops.embedding_bag_hotcold_int8_shard(hot, shard, split)
    return ops.embedding_bag_hotcold_int8_rowwise_shard(hot, shard, split)


_NO_HITS: dict = {}


def _no_hits(shape, device) -> torch.Tensor:
    """An all-false hot mask, made once a (shape, device): the shards other
    than the first count no hot hit, so the hot part is counted once. The
    engines' threads share it, each on its own stream, so it is filled
    before it is handed out."""
    key = (tuple(shape), device)
    t = _NO_HITS.get(key)
    if t is None:
        t = torch.zeros(shape, dtype=torch.bool, device=device)
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        _NO_HITS[key] = t
    return t


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _hotcold_row(mesh: Mesh, d: int, hot_of: Callable, shard_of: Callable, hot_sel, hot_mask,
                 cold_local, cold_seg, layout: str, cdt, scale_on) -> torch.Tensor:
    """One data row's hot/cold lookup: K6 a shard on its own cold stream,
    the real hot mask on shard 0 only; partials combined on entry (d, 0)."""
    out_dev = mesh.device(d, 0)
    partials = []
    for m in range(mesh.shape["model"]):
        dev = mesh.device(d, m)
        sel = _to(hot_sel, dev)
        hits = _to(hot_mask, dev) if m == 0 else _no_hits(hot_mask.shape, dev)
        split = {"hot_sel": sel, "hot_mask": hits, "cold_ids": _to(cold_local[m], dev),
                 "cold_seg": _to(cold_seg[m], dev)}
        partials.append(_hotcold_shard_partial(layout, hot_of(m), shard_of(m), split, cdt))
    return _finish(_combine(partials, out_dev), layout, cdt, scale_on(out_dev))


def _hot_rows(mesh: Mesh, hot_table) -> Callable:
    """``hot_table``: a tensor (replicated here) or ``(d, m) -> entry (d,
    m)'s copy``."""
    if callable(hot_table):
        return hot_table
    rep = Replicated(mesh, hot_table)
    return lambda d, m: rep.on(mesh.device(d, m))


def _rows_of(mesh: Mesh, table) -> Sharded:
    return table if isinstance(table, Sharded) else Sharded.rows(table, mesh)


def _no_pack(pack: int):
    if pack != 1:
        raise NotImplementedError("packed cold tables: the port keeps (R, d) rows "
                                  "(bridge.params_from_numpy unpacks them)")


def sharded_embedding_bag_hotcold(hot_table, table, split: dict, mesh: Mesh, *,
                                  compute_dtype: torch.dtype | None = None, table_scale=None,
                                  rowwise: bool = False, pack: int = 1) -> torch.Tensor:
    """Hot/cold lookup over a row-sharded table, tensor-parallel (JAX
    ``sharding.py:172-225``): ``split`` from ``ops/hotcold.py::
    split_hot_cold_sharded`` (``cold_local``/``cold_seg`` ``(M, C_pad)``,
    shard-local ids). The batch is not split: it runs on row 0 of the mesh,
    K6 a shard on that shard's cold stream, the hot hits counted on shard 0;
    the partials are summed and finished (``table_scale``: per-table int8,
    ``rowwise``: row-wise int8). ``table``: the fused table (or its 2-D int8
    leaf), sharded here, or its ``Sharded`` rows; ``hot_table`` a tensor or
    ``(d, m) -> entry (d, m)'s copy``. Returns ``(B, T, d)`` on
    ``mesh.devices.flat[0]``."""
    _no_pack(pack)
    rows = _rows_of(mesh, table)
    hot = _hot_rows(mesh, hot_table)
    layout = _quant_layout(table_scale, rowwise)
    cdt = compute_dtype or (torch.float32 if layout != "float" else rows.part(0, 0).dtype)
    cold_local, cold_seg = _tensor(split["cold_local"]), _tensor(split["cold_seg"])
    return _hotcold_row(mesh, 0, lambda m: hot(0, m), lambda m: rows.part(0, m),
                        _tensor(split["hot_sel"]), _tensor(split["hot_mask"]), cold_local,
                        cold_seg, layout, cdt, lambda dev: _to(table_scale, dev)
                        if table_scale is not None else None)


def hybrid_hotcold_rows(hot_table, table, split: dict, mesh: Mesh, *,
                        compute_dtype: torch.dtype | None = None, table_scale=None,
                        rowwise: bool = False) -> list:
    """``hybrid_embedding_bag_hotcold``'s data slices: slice d's pooled
    lookup on entry (d, 0), for each d."""
    rows = _rows_of(mesh, table)
    hot = _hot_rows(mesh, hot_table)
    layout = _quant_layout(table_scale, rowwise)
    cdt = compute_dtype or (torch.float32 if layout != "float" else rows.part(0, 0).dtype)
    hot_sel, hot_mask = _tensor(split["hot_sel"]), _tensor(split["hot_mask"])
    cold_local, cold_seg = _tensor(split["cold_local"]), _tensor(split["cold_seg"])
    D = mesh.shape["data"]
    B = hot_sel.shape[0]
    if B % D:
        raise ValueError(f"batch {B} does not divide over data axis {D}")
    b = B // D
    return [_hotcold_row(mesh, d, lambda m, d=d: hot(d, m), lambda m, d=d: rows.part(d, m),
                         hot_sel[d * b:(d + 1) * b], hot_mask[d * b:(d + 1) * b], cold_local[d],
                         cold_seg[d], layout, cdt,
                         lambda dev: _to(table_scale, dev) if table_scale is not None else None)
            for d in range(D)]


def hybrid_embedding_bag_hotcold(hot_table, table, split: dict, mesh: Mesh, *,
                                 compute_dtype: torch.dtype | None = None, table_scale=None,
                                 rowwise: bool = False, pack: int = 1) -> torch.Tensor:
    """Hot/cold lookup on the full (data x model) mesh (JAX
    ``sharding.py:228-283``): ``split`` from ``split_hot_cold_hybrid``
    (``cold_local``/``cold_seg`` ``(D, M, C_pad)``, segments local to each
    data slice, ``b_loc * T + t``, pads ``b_loc * T``). Data slice d runs K6
    a shard on cell (d, m)'s stream with ``n_bags = b_loc * T`` and its
    slice of the hot hits on shard 0; each row's partials are combined on
    entry (d, 0). Returns ``(B, T, d)`` on ``mesh.devices.flat[0]``."""
    _no_pack(pack)
    out = hybrid_hotcold_rows(hot_table, table, split, mesh, compute_dtype=compute_dtype,
                              table_scale=table_scale, rowwise=rowwise)
    return torch.cat([_to(o, mesh.devices.flat[0]) for o in out], dim=0)


# ----------------------------------------------------------------------
# Table-wise sharding (placement-driven)
# ----------------------------------------------------------------------


def build_tablewise_tables(fused_table: torch.Tensor, cfg: ModelConfig,
                           placement) -> torch.Tensor:
    """The fused ``(total_rows, W)`` table in the table-wise layout
    ``(M, rows_per_shard, W)`` (JAX ``sharding.py:289-308``): shard s holds
    its placed tables concatenated, zero-padded to the common row count."""
    w = fused_table.shape[1]
    offsets, rows = cfg.table_offsets, cfg.scaled_rows
    n_real = placement.num_real_tables
    out = torch.zeros((placement.num_shards, placement.rows_per_shard, w),
                      dtype=fused_table.dtype, device=fused_table.device)
    for s, group in enumerate(placement.tables_per_shard):
        at = 0
        for t in group:
            if t < n_real:  # virtual pad tables hold no rows
                out[s, at:at + rows[t]] = fused_table[offsets[t]:offsets[t] + rows[t]]
                at += rows[t]
    return out


class TablewisePlan:
    """What a table-wise lookup reads besides the ids, built once a
    (placement, mesh, scales): the table permutation (on the host and each
    mesh device), each shard's table offsets within it and, for per-table
    int8, its placed tables' scales, on the devices of that shard's column,
    and the inverse permutation on every device. A virtual pad slot's offset
    is 0: it reads the shard's row 0 (JAX ``sharding.py:348-357``); its
    planned offset, the sum of its shard's real rows, may equal the shard's
    row count. ``table_scale``: the ``(T,)`` scales of per-table int8."""

    def __init__(self, placement, mesh: Mesh, table_scale: torch.Tensor | None = None):
        M = placement.num_shards
        if M != mesh.shape["model"]:
            raise ValueError(f"placement for {M} shards on model axis {mesh.shape['model']}")
        self.placement, self.mesh = placement, mesh
        n_real = placement.num_real_tables
        self.cap = len(placement.perm) // M
        self.n_pad = len(placement.perm) - n_real
        perm = torch.as_tensor(placement.perm, dtype=torch.long)
        local_off = torch.as_tensor(placement.local_offsets, dtype=torch.int32)
        local_off[perm >= n_real] = 0
        self._perm = {torch.device("cpu"): perm, **Replicated(mesh, perm).copies}
        self.local_off = Sharded.stacked(local_off.reshape(M, self.cap), mesh)
        self.scale = None
        if table_scale is not None:
            scale = torch.cat([table_scale.float().cpu(), torch.zeros(self.n_pad)])
            self.scale = Sharded.stacked(scale[perm].reshape(M, self.cap), mesh)
        self.inv = Replicated(mesh, torch.as_tensor(placement.inv_perm[:n_real],
                                                    dtype=torch.long))

    def perm_on(self, device: torch.device) -> torch.Tensor:
        t = self._perm.get(device)
        return t if t is not None else self._perm[torch.device("cpu")].to(device)

    def cells(self, indices: torch.Tensor, mask: torch.Tensor | None):
        """Each (data slice d, shard s) cell's lookup inputs on entry (d,
        s)'s device: ``(d, s, ids (b, cap, L), mask or None, the placed
        tables' offsets (cap,), their scales (cap,) or None)``. ``indices``
        and ``mask`` are in the original table order; virtual slots get id 0
        (and a false mask where there is one)."""
        M, D, cap = self.placement.num_shards, self.mesh.shape["data"], self.cap
        indices = torch.as_tensor(indices)
        B, _, L = indices.shape
        if self.n_pad:
            indices = torch.cat([indices, indices.new_zeros((B, self.n_pad, L))], dim=1)
            if mask is not None:
                mask = torch.cat([mask, mask.new_zeros((B, self.n_pad, L))], dim=1)
        idx_perm = indices.index_select(1, self.perm_on(indices.device))
        mask_perm = None if mask is None else mask.index_select(1, self.perm_on(mask.device))
        if B % D:
            raise ValueError(f"batch {B} does not divide over data axis {D}")
        b = B // D
        for d in range(D):
            for s in range(M):
                dev = self.mesh.device(d, s)
                idx = _to(idx_perm[d * b:(d + 1) * b, s * cap:(s + 1) * cap].contiguous(), dev)
                msk = None if mask_perm is None else _to(
                    mask_perm[d * b:(d + 1) * b, s * cap:(s + 1) * cap].contiguous(), dev)
                yield (d, s, idx, msk, self.local_off.part(d, s),
                       None if self.scale is None else self.scale.part(d, s))


def tablewise_rows(shard_tables, indices: torch.Tensor, plan: TablewisePlan, *,
                   compute_dtype: torch.dtype | None = None, mask: torch.Tensor | None = None,
                   rowwise: bool = False) -> list:
    """``tablewise_embedding_bag``'s data slices on ``plan``'s mesh: slice
    d's ``(b, T, d)`` pooled lookup on entry (d, 0), for each d."""
    from deeprecsys_tpu_torch import ops

    mesh = plan.mesh
    shards = (shard_tables if isinstance(shard_tables, Sharded)
              else Sharded.stacked(shard_tables, mesh))
    cdt = compute_dtype or (torch.float32 if shards.part(0, 0).dtype == torch.int8
                            else shards.part(0, 0).dtype)
    slices: list = [[] for _ in range(mesh.shape["data"])]
    for d, s, idx, msk, offs, scale in plan.cells(indices, mask):
        tbl = shards.part(d, s)
        if rowwise:
            pooled = ops.embedding_bag_int8_rowwise(tbl, offs, idx, compute_dtype=cdt, mask=msk)
        elif scale is not None:
            pooled = ops.embedding_bag_int8(tbl, scale, offs, idx, compute_dtype=cdt, mask=msk)
        else:
            pooled = ops.embedding_bag(tbl, offs, idx, compute_dtype=cdt, mask=msk)
        slices[d].append(_to(pooled, mesh.device(d, 0)))
    return [torch.cat(row, dim=1).index_select(1, plan.inv.on(mesh.device(d, 0)))
            for d, row in enumerate(slices)]


def tablewise_embedding_bag(shard_tables, indices: torch.Tensor, placement, mesh: Mesh, *,
                            compute_dtype: torch.dtype | None = None,
                            mask: torch.Tensor | None = None, table_scale=None,
                            rowwise: bool = False) -> torch.Tensor:
    """Pooled lookup with table-wise sharding (JAX ``sharding.py:311-397``):
    shard s pools only its own tables (the direct kernel of the layout on
    the shard with the tables' offsets within it: K1, K1-int8 with the
    placed tables' ``table_scale``, or K4 with ``rowwise``), the combine is
    a ``torch.cat`` of the shards' ``(b, cap, d)`` slices on entry (d, 0)
    (the JAX ``all_gather``), and the inverse permutation restores the
    original table order. ``indices`` and ``mask`` are in the original
    order; virtual pad tables read the shard's row 0 with a false mask and
    are dropped. ``shard_tables``: ``(M, rows_per_shard, W)``
    (``build_tablewise_tables``) or its ``Sharded`` shards. Returns
    ``(B, T, d)`` in the compute dtype on ``mesh.devices.flat[0]``."""
    out = tablewise_rows(shard_tables, indices, TablewisePlan(placement, mesh, table_scale),
                         compute_dtype=compute_dtype, mask=mask, rowwise=rowwise)
    return torch.cat([_to(o, mesh.devices.flat[0]) for o in out], dim=0)


# ----------------------------------------------------------------------
# Training losses
# ----------------------------------------------------------------------


def bce_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on sigmoid scores, clipped to [1e-7, 1 - 1e-7];
    a score outside the clip gets no gradient (the clip's VJP)."""
    eps = 1e-7
    s = torch.clamp(scores.float(), eps, 1.0 - eps)
    t = targets.float()
    return -torch.mean(t * torch.log(s) + (1.0 - t) * torch.log(1.0 - s))


def bce_logits_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on raw logits, in the stable form
    max(s, 0) - s t + log1p(exp(-|s|)), for the families whose graphs end
    without a sigmoid (ncf, din, dien)."""
    s = scores.float()
    t = targets.float()
    return torch.mean(torch.clamp_min(s, 0.0) - s * t + torch.log1p(torch.exp(-torch.abs(s))))


def mse_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((scores.float() - targets.float()) ** 2)


def loss_fn_for(loss: str, sigmoid_output: bool):
    """"bce" in probability space for sigmoid-headed models (dlrm, wnd,
    mtwnd) and in logit space otherwise (ncf, din, dien); or "mse"."""
    if loss == "mse":
        return mse_loss
    if loss == "bce":
        return bce_loss if sigmoid_output else bce_logits_loss
    raise ValueError(f"unknown loss {loss!r} (use 'bce' or 'mse')")
