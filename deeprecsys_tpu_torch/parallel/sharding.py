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
  (d, 0); the slices' scores are concatenated on ``mesh.home``
  (``concat_slices``).

Each launch goes to the current stream of its entry's device. A partial
moved between two devices is ordered by PyTorch's cross-device copy, which
waits on the current streams of both by events; on one device everything
is on one stream. ``tests/test_torch_mesh_gpu.py`` holds the order across
several cards to the single-device forward; the CPU tests reach it by
naming each entry of a CPU mesh a card of its own (``card_plan(places=)``).

The mesh engines' programs (``serving/programs.py``) run the same forward
cut into parts, one a card and job (``card_plan``, ``mesh_stages``): a part
on each card that pools the shards of rows combined on another card, then
a part on each card that sums its rows in shard order (its own partials
and those received), finishes them and runs the tail, ``mesh.home``'s last
with the concat. Each part reads only tensors on its own card: the
partials and slices that cross cards are copied by the caller into
receive buffers there, so that each part can be captured as a CUDA graph
of its card. The pieces and their order are ``sharded_apply``'s (and the
mesh hot/cold model's), so the parts compute their scores bit for bit.

Table-wise sharding (``build_tablewise_tables``, ``tablewise_embedding_bag``)
places whole tables on shards (``placement.py``); each shard pools its own
tables with the direct kernels and the combine is a ``torch.cat`` (the JAX
``all_gather``), then the inverse permutation. The hot/cold lookups over a
mesh run K6 on each shard's cold stream (``sharded_embedding_bag_hotcold``:
tensor-parallel, the batch on row 0; ``hybrid_embedding_bag_hotcold``: a
cold stream a (data, model) cell).

Training over a mesh (``make_train_step`` here, and ``train.py``'s
``Trainer(mesh=)`` and ``make_sharded_sparse_table_step``): the same
lookup under autograd, each shard's partial an ``EmbeddingBagShardFunction``
(forward K1's window, backward K1b's window), the loss the mean of the data
slices' mean losses (the JAX ``pmean`` over "data"). Autograd sums the
gradient of a tensor that several entries share (a one-card mesh holds each
leaf once), and ``reduce_copies`` adds the gradients of a leaf's copies on
distinct devices (the JAX ``psum`` of the replicated leaves' gradients), so
each distinct tensor takes the whole gradient once and its update exactly
once (``leaf_copies``). ``unshard_params`` reads the full params back. The
losses at the end are the JAX module's (:427-462). The trainers' programs
run a step over several cards cut into parts by card
(``train_places``, ``mesh_train_stages``), each part a CUDA graph of its
card, the same pieces in the same order.

Across processes (a ``Mesh`` whose entries several processes own,
``mesh.py``): each process places and launches on its own entries only
(remote entries hold None), every process takes the same host batch and
loops over the rows, columns and leaves in one fixed order, and the
combines become collectives (``Mesh.all_reduce``, ``broadcast``): the sum
over "model" adds a process's local partials, then sums over the row's
processes; the concat over "data" sends each row's slice from entry (d,
0)'s process to every process (``all_gather_slices``); the loss is gathered
so that every process returns it; ``reduce_copies`` sums a leaf's copies
over the processes that hold them; the dense step's row sum takes its
backward as a broadcast of the row's pooled gradient (``row_partial``);
``unshard_params`` gathers the shards. The hot/cold lookups take the
same pattern: K6 on each local shard of a row (the hot hits where the
process holds (d, 0)), the row's partials summed over its processes, the
slices gathered; every process makes the split itself from the same host
batch (the splitter is deterministic), so nothing is sent for it. A
table-wise row's cells, each pooled by its own process, are sent to entry
(d, 0)'s process (``_gather_row_cells``, the JAX ``all_gather`` over
"model"), then the slices are gathered. The mesh engines
(``ComputeEngine(mesh=)``) serve from one process, as the JAX package's
do, and raise there (``Mesh.require_one_process``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from deeprecsys_tpu_torch import bridge
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
        """Shard m on each of this process's entries of column m (None on
        another process's): keyed by device, which names one place within a
        process."""
        cache: dict = {}
        parts = []
        for d in range(mesh.shape["data"]):
            row = []
            for m in range(mesh.shape["model"]):
                if not mesh.is_local(d, m):
                    row.append(None)
                    continue
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

    def first(self) -> torch.Tensor:
        """This process's first shard tensor (row-major over the entries)."""
        return next(p for row in self.parts for p in row if p is not None)

    @property
    def rows_per_shard(self) -> int:
        return int(self.first().shape[0])


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

    def entry(self, d: int, m: int) -> dict | None:
        """Entry (d, m)'s params; None where another process holds it."""
        return self.entries[d][m]

    def first_entry(self) -> dict:
        """This process's first entry (row-major)."""
        return next(e for row in self.entries for e in row if e is not None)

    def with_leaf(self, key: str, t: torch.Tensor) -> "ShardedParams":
        """The same params with top-level leaf ``key`` replaced by ``t``,
        replicated: one copy a distinct device."""
        rep = Replicated(self.mesh, t)
        entries = [[None if e is None else {**e, key: rep.on(self.mesh.device(d, m))}
                    for m, e in enumerate(row)] for d, row in enumerate(self.entries)]
        return ShardedParams(self.mesh, entries, self.rows_per_shard)

    def write_leaf(self, key: str, t: torch.Tensor):
        """Copy ``t`` into top-level leaf ``key`` in place: into its one
        tensor on each distinct device, on that device's current stream. A
        program captured over these params reads the new values (a
        ``with_leaf`` copy it would never see)."""
        done: set = set()
        for row in self.entries:
            for e in row:
                if e is None or id(e[key]) in done:
                    continue
                dst = e[key]
                if dst.shape != t.shape or dst.dtype != t.dtype:
                    raise ValueError(f"leaf {key!r} is {tuple(dst.shape)} {dst.dtype}; cannot "
                                     f"write {tuple(t.shape)} {t.dtype} into it")
                dst.copy_(t, non_blocking=dst.device.type == "cuda")
                done.add(id(dst))

    def tensors(self) -> list:
        """Every distinct tensor the entries hold."""
        from deeprecsys_tpu_torch.utils.checkpoint import tree_flatten

        seen: dict = {}
        for row in self.entries:
            for e in row:
                if e is None:
                    continue
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
    leaf, one tensor a (device, shard) of each sharded table leaf, on this
    process's entries only (another process's entry is None)."""
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
            if not mesh.is_local(d, m):
                row.append(None)
                continue
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


def _shard_partial(layout: str, tables, offsets, indices, row_lo: int, cdt, mask,
                   table_range=None):
    """Shard ``row_lo``'s partial for the table's layout; ``table_range``
    (the shard's ``ops.embedding.TableRange``, or None) goes to the kernels
    that launch over the meeting tables alone: K1b's window (the float
    lookup's backward), K1-int8's and K4's."""
    from deeprecsys_tpu_torch import ops

    if layout == "float":
        return ops.embedding_bag_shard(tables, offsets, indices, row_lo, compute_dtype=cdt,
                                       mask=mask, table_range=table_range)
    if layout == "int8":
        return ops.embedding_bag_int8_shard(tables["q"], offsets, indices, row_lo, mask=mask,
                                            table_range=table_range)
    return ops.embedding_bag_int8_rowwise_shard(tables["qrows"], offsets, indices, row_lo,
                                                mask=mask, table_range=table_range)


@functools.lru_cache(maxsize=256)
def shard_table_ranges(cfg: ModelConfig, rows_per_shard: int, n_model: int) -> tuple:
    """Each row shard's ``TableRange`` (the tables that meet it), made once
    a (config, placement) from the config's table offsets on the host: no
    offsets are read back from a card. The last table ends at the padded
    fused table's end, ``rows_per_shard * n_model``."""
    from deeprecsys_tpu_torch.ops.embedding import table_range

    return tuple(table_range(cfg.table_offsets, m * rows_per_shard, rows_per_shard,
                             rows_per_shard * n_model) for m in range(n_model))


def _row_partial(entry_tables: Callable, mesh: Mesh, d: int, rows_per_shard: int,
                 offsets: Replicated, indices, mask, cdt, layout: str, ranges=None):
    """This process's part of row d's pooled lookup: a partial a local
    shard (the window), added in shard order on the row's first local
    entry; None where the process holds none of row d. ``ranges``: each
    shard's table range (``shard_table_ranges``), or None."""
    local = [m for m in range(mesh.shape["model"]) if mesh.is_local(d, m)]
    if not local:
        return None
    moved: dict = {}
    partials = []
    for m in local:
        dev = mesh.device(d, m)
        if dev not in moved:
            moved[dev] = (_to(indices, dev), None if mask is None else _to(mask, dev))
        idx, msk = moved[dev]
        partials.append(_shard_partial(layout, entry_tables(m), offsets.on(dev), idx,
                                       m * rows_per_shard, cdt, msk,
                                       None if ranges is None else ranges[m]))
    return _combine(partials, mesh.device(d, local[0]))


def _row_sum(mesh: Mesh, d: int, acc: torch.Tensor | None) -> torch.Tensor | None:
    """The rest of the ``psum`` over "model": this process's part of row d
    (``_row_partial``; None where it holds none of the row) summed over the
    row's processes (a collective only where they are several; an int32
    pool stays exact), on entry (d, 0); None in every other process."""
    if acc is None:
        return None
    acc = mesh.all_reduce(acc, mesh.row_ranks(d))
    return _to(acc, mesh.device(d, 0)) if mesh.is_local(d, 0) else None


def all_gather_slices(mesh: Mesh, slices: list, shape: tuple, dtype: torch.dtype) -> list:
    """The concat over "data": row d's slice (on entry (d, 0), None in
    another process) of every row, in row order. Across processes each row
    is sent from its entry (d, 0)'s process to every process (a broadcast a
    row into a buffer of ``shape`` and ``dtype``, which every slice has),
    and lands on this process's first device."""
    if not mesh.multi_process:
        return slices
    for s in slices:
        if s is not None and (tuple(s.shape) != tuple(shape) or s.dtype != dtype):
            raise ValueError(f"a data slice is {tuple(s.shape)} {s.dtype}, not the "
                             f"{tuple(shape)} {dtype} every process gathers")
    return [mesh.broadcast(s if s is not None else torch.empty(shape, dtype=dtype,
                                                               device=mesh.home),
                           mesh.rank_of(d, 0), mesh.all_ranks)
            for d, s in enumerate(slices)]


def concat_slices(mesh: Mesh, slices: list, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The data slices (``all_gather_slices``' input) concatenated on
    ``mesh.home``: the whole batch's result, on every process."""
    return torch.cat([_to(s, mesh.home) for s in all_gather_slices(mesh, slices, shape, dtype)],
                     dim=0)


def sharded_embedding_bag(table, offsets: torch.Tensor, indices: torch.Tensor, mesh: Mesh,
                          total_rows: int, *, compute_dtype: torch.dtype | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup with the table row-sharded over "model" and the batch
    over "data" (JAX ``sharding.py:133-169``): ``table`` is the fused
    ``(total_rows, d)`` float table (sharded here) or its ``Sharded`` rows.
    Each shard pools the rows it owns (K1 with the window), one sum over the
    shards completes each data slice; returns ``(B, T, d)`` in the compute
    dtype on ``mesh.home`` (every process's, across processes).
    ``total_rows`` must divide over the model axis (``pad_rows_for_mesh``)."""
    n_model = mesh.shape["model"]
    if total_rows % n_model:
        raise ValueError(f"total rows {total_rows} must divide over model axis {n_model}; "
                         "pad the last table (see pad_rows_for_mesh)")
    rows = table if isinstance(table, Sharded) else Sharded.rows(table, mesh)
    cdt = compute_dtype if compute_dtype is not None else rows.first().dtype
    offs = Replicated(mesh, offsets)
    out = []
    for d, sl in enumerate(split_batch(Batch(dense=None, indices=indices, mask=mask), mesh)):
        acc = _row_sum(mesh, d, _row_partial(lambda m, d=d: rows.part(d, m), mesh, d,
                                             total_rows // n_model, offs, sl.indices, sl.mask,
                                             cdt, "float"))
        out.append(None if acc is None else _finish(acc, "float", cdt))
    b, nt = indices.shape[0] // mesh.shape["data"], indices.shape[1]
    return concat_slices(mesh, out, (b, nt, rows.first().shape[1]), cdt)


def pad_rows_for_mesh(cfg: ModelConfig, n_model: int) -> int:
    """Rows of padding needed so the fused table divides over the model axis."""
    r = cfg.total_rows % n_model
    return 0 if r == 0 else n_model - r


def pooled_on_row(sp: ShardedParams, d: int, batch: Batch, cfg: ModelConfig,
                  offsets: Replicated) -> torch.Tensor | None:
    """Row d's pooled lookup for the table's layout, on entry (d, 0); None in
    a process that does not hold entry (d, 0) (its shards' partials go
    there)."""
    from deeprecsys_tpu_torch.models.base import pooled_lookup

    mesh = sp.mesh
    if sp.rows_per_shard is None:  # a replicated table: the direct lookup
        if not mesh.is_local(d, 0):
            return None
        dev0 = mesh.device(d, 0)
        b = _batch_to(batch, dev0)
        return pooled_lookup(sp.entry(d, 0)["tables"], b, cfg, offsets=offsets.on(dev0))
    acc, finish = row_partial(sp, d, batch, cfg, offsets)
    acc = _row_sum(mesh, d, acc)
    return None if acc is None else finish(acc)


def row_partial(sp: ShardedParams, d: int, batch: Batch, cfg: ModelConfig,
                offsets: Replicated):
    """This process's part of row d's row-sharded lookup and how entry (d,
    0) finishes the row's sum: ``(partial, finish)``; the partial is None
    where the process holds none of row d. ``pooled_on_row`` is ``finish``
    of the partial summed over the row's processes (``_row_sum``)."""
    mesh = sp.mesh
    layout, cdt = _layout(sp.first_entry()["tables"]), compute_dtype_of(cfg)
    acc = _row_partial(lambda m: sp.entry(d, m)["tables"], mesh, d, sp.rows_per_shard, offsets,
                       batch.indices, batch.mask, cdt, layout,
                       shard_table_ranges(cfg, sp.rows_per_shard, mesh.shape["model"]))

    def finish(acc):
        scale = sp.entry(d, 0)["tables"]["scale"] if layout == "int8" else None
        return _finish(acc, layout, cdt, scale)

    return acc, finish


def sharded_apply(model: ModelFns, mesh: Mesh, has_dense: bool) -> Callable:
    """The model's forward over the mesh (JAX ``sharding.py:411-425``, which
    jits ``model.apply`` and leaves the collectives to GSPMD). The port
    takes the ``ModelFns`` (its ``apply_from_pooled``) and no params, and
    returns ``fn(sharded_params, batch) -> scores``: for each data slice,
    the row-sharded lookup of the table's layout (K1, K1-int8 or K4 with the
    window, combined, finished), then ``apply_from_pooled`` on entry (d, 0)
    (dien's K3 there too); the slices' scores concatenated on
    ``mesh.home`` (``all_gather_slices``: across processes every process
    gets the whole batch's). ``sharded_params`` is ``shard_params``' (placed
    once, not a call); the batch on any device (pinned host memory copies
    asynchronously), the same batch on every process."""
    cfg = model.cfg
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))

    def fn(sp: ShardedParams, batch: Batch) -> torch.Tensor:
        if not isinstance(sp, ShardedParams):
            raise TypeError(f"sharded_apply's fn takes shard_params(params, mesh), not "
                            f"{type(sp).__name__}")
        _check_dense(has_dense, batch)
        scores, slices = [], split_batch(batch, mesh)
        for d, sl in enumerate(slices):
            pooled = pooled_on_row(sp, d, sl, cfg, offsets)
            if pooled is None:
                scores.append(None)
                continue
            dev0 = mesh.device(d, 0)
            tail = Batch(dense=None if sl.dense is None else _to(torch.as_tensor(sl.dense), dev0),
                         indices=None, mask=None)
            scores.append(model.apply_from_pooled(sp.entry(d, 0), pooled, tail))
        return concat_slices(mesh, scores, (slices[0].indices.shape[0], cfg.out_dim),
                             compute_dtype_of(cfg))

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


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _hotcold_row_partial(mesh: Mesh, d: int, hot_of: Callable, shard_of: Callable, hot_sel,
                         hot_mask, cold_local, cold_seg, layout: str, cdt):
    """This process's part of row d's hot/cold lookup: K6 on each of its
    shards of the row, on that shard's own cold stream (the JAX shard body
    ``local_fn``), the hot hits counted on shard 0 (K6 with them, where this
    process holds entry (d, 0)) and every other shard's cold stream pooled
    alone (K6's cold-only route); the partials added in shard order on the
    row's first local entry. None where the process holds none of row d.
    The per-table int8 partial is int32, the others f32."""
    local = [m for m in range(mesh.shape["model"]) if mesh.is_local(d, m)]
    if not local:
        return None
    bags = tuple(hot_sel.shape[:2])
    partials = []
    for m in local:
        dev = mesh.device(d, m)
        split = {"cold_ids": _to(cold_local[m], dev), "cold_seg": _to(cold_seg[m], dev)}
        if m == 0:
            split.update(hot_sel=_to(hot_sel, dev), hot_mask=_to(hot_mask, dev))
            partials.append(_hotcold_shard_partial(layout, hot_of(m), shard_of(m), split, cdt))
        else:
            partials.append(_hotcold_shard_partial(layout, None, shard_of(m),
                                                   dict(split, bags=bags), cdt))
    return _combine(partials, mesh.device(d, local[0]))


def _hotcold_row(mesh: Mesh, d: int, hot_of: Callable, shard_of: Callable, hot_sel, hot_mask,
                 cold_local, cold_seg, layout: str, cdt, scale) -> torch.Tensor | None:
    """Row d's hot/cold lookup on entry (d, 0) (None in every other
    process): this process's part (``_hotcold_row_partial``) summed over the
    row's processes (``_row_sum``; an int32 pool stays exact), then
    finished once (``scale``: per-table int8's, or None)."""
    acc = _row_sum(mesh, d, _hotcold_row_partial(mesh, d, hot_of, shard_of, hot_sel, hot_mask,
                                                 cold_local, cold_seg, layout, cdt))
    if acc is None:
        return None
    return _finish(acc, layout, cdt, None if scale is None else _to(scale, acc.device))


def _hot_rows(mesh: Mesh, hot_table) -> Callable:
    """``hot_table``: a tensor (replicated here, a copy a call where it is
    not on every device) or ``(d, m) -> entry (d, m)'s copy``, which the
    engines pass: a captured program reads their own hot tables."""
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


def _hotcold_lookup(hot_table, table, split: dict, mesh: Mesh, hybrid: bool, compute_dtype,
                    table_scale, rowwise: bool) -> tuple:
    """``(slices, shape, dtype)``: the lookup's data slices, slice d on entry
    (d, 0) and None where another process holds that entry (hybrid: one a
    data row; tensor-parallel: the whole batch on row 0), and the shape and
    dtype every slice has."""
    rows = _rows_of(mesh, table)
    hot = _hot_rows(mesh, hot_table)
    layout = _quant_layout(table_scale, rowwise)
    first = rows.first()
    cdt = compute_dtype or (torch.float32 if layout != "float" else first.dtype)
    width = first.shape[1] - (4 if rowwise else 0)  # a row-wise row ends in its f32 scale
    hot_sel, hot_mask = _tensor(split["hot_sel"]), _tensor(split["hot_mask"])
    cold_local, cold_seg = _tensor(split["cold_local"]), _tensor(split["cold_seg"])
    B, T = hot_sel.shape[:2]
    if not hybrid:
        return [_hotcold_row(mesh, 0, lambda m: hot(0, m), lambda m: rows.part(0, m), hot_sel,
                             hot_mask, cold_local, cold_seg, layout, cdt, table_scale)], \
            (B, T, width), cdt
    D = mesh.shape["data"]
    if B % D:
        raise ValueError(f"batch {B} does not divide over data axis {D}")
    b = B // D
    return [_hotcold_row(mesh, d, lambda m, d=d: hot(d, m), lambda m, d=d: rows.part(d, m),
                         hot_sel[d * b:(d + 1) * b], hot_mask[d * b:(d + 1) * b], cold_local[d],
                         cold_seg[d], layout, cdt, table_scale)
            for d in range(D)], (b, T, width), cdt


def sharded_hotcold_rows(hot_table, table, split: dict, mesh: Mesh, *,
                         compute_dtype: torch.dtype | None = None, table_scale=None,
                         rowwise: bool = False) -> list:
    """``sharded_embedding_bag_hotcold``'s one row: ``[pooled]``, the whole
    batch's lookup on entry (0, 0), or ``[None]`` in a process that does not
    hold it."""
    return _hotcold_lookup(hot_table, table, split, mesh, False, compute_dtype, table_scale,
                           rowwise)[0]


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
    ``(d, m) -> entry (d, m)'s copy``. Across processes every process makes
    the same split from the same host batch and launches on its own shards
    of row 0; the row's sum crosses the row's processes (an all-reduce of
    the partials) and the result is sent from entry (0, 0)'s process to
    every process. Returns ``(B, T, d)`` on ``mesh.home``."""
    _no_pack(pack)
    return concat_slices(mesh, *_hotcold_lookup(hot_table, table, split, mesh, False,
                                                compute_dtype, table_scale, rowwise))


def hybrid_hotcold_rows(hot_table, table, split: dict, mesh: Mesh, *,
                        compute_dtype: torch.dtype | None = None, table_scale=None,
                        rowwise: bool = False) -> list:
    """``hybrid_embedding_bag_hotcold``'s data slices: slice d's pooled
    lookup on entry (d, 0), for each d; None for a slice whose entry (d, 0)
    another process holds. Across processes each row's partials are summed
    over the row's processes (``_hotcold_row``)."""
    return _hotcold_lookup(hot_table, table, split, mesh, True, compute_dtype, table_scale,
                           rowwise)[0]


def hybrid_embedding_bag_hotcold(hot_table, table, split: dict, mesh: Mesh, *,
                                 compute_dtype: torch.dtype | None = None, table_scale=None,
                                 rowwise: bool = False, pack: int = 1) -> torch.Tensor:
    """Hot/cold lookup on the full (data x model) mesh (JAX
    ``sharding.py:228-283``): ``split`` from ``split_hot_cold_hybrid``
    (``cold_local``/``cold_seg`` ``(D, M, C_pad)``, segments local to each
    data slice, ``b_loc * T + t``, pads ``b_loc * T``). Data slice d runs K6
    a shard on cell (d, m)'s stream with ``n_bags = b_loc * T`` and its
    slice of the hot hits on shard 0; each row's partials are combined on
    entry (d, 0) (across processes: summed over the row's processes). The
    slices are concatenated on ``mesh.home`` (across processes each is sent
    from entry (d, 0)'s process to every process): ``(B, T, d)``."""
    _no_pack(pack)
    return concat_slices(mesh, *_hotcold_lookup(hot_table, table, split, mesh, True,
                                                compute_dtype, table_scale, rowwise))


# ----------------------------------------------------------------------
# The mesh forward cut into parts, one a card (the engines' programs)
# ----------------------------------------------------------------------


class CardPart(NamedTuple):
    """One card's share of a one-process mesh forward (``card_plan``).
    ``shards``: the entries (d, m) whose partial it pools and sends to row
    d's entry (d, 0), which is on another card. ``rows``: the data rows
    whose sum over "model" (its own shards' partials and those it received,
    in shard order), finish and tail it runs. ``concat``: the last part, on
    ``mesh.home``, which concatenates the slices."""

    place: object
    device: torch.device
    shards: tuple
    rows: tuple
    concat: bool


class Stage(NamedTuple):
    """A part made runnable (``mesh_stages``, ``mesh_train_stages``):
    ``fn(recv)`` runs the part's work on ``device`` alone and returns its
    outputs by key; ``sends`` maps each output another part reads to that
    part's device, where the caller copies it into ``recv[key]`` (a buffer
    it keeps) before that part runs. One stage's outputs hold ``"out"``
    (the forward's last: the whole batch's scores; a training step's: its
    loss). ``part``: a training step's ``(kind, place)``."""

    device: torch.device
    fn: Callable[[dict], dict]
    sends: dict
    part: tuple | None = None


def card_plan(mesh: Mesh, places=None, sharded: bool = True) -> tuple:
    """The mesh forward of one process cut into parts, one a card and job,
    in the order they run: first a part on each card that pools shards of
    rows combined on another card, then a part on each card that combines
    rows, ``mesh.home``'s last (it concatenates the slices). A plain
    function of the entries' places: ``places`` is a (D, M) grid of labels,
    the entries' devices by default; entries of one label share a card.
    A one-card mesh gives one part, the whole forward. ``sharded`` False
    (a replicated table): each row's whole lookup on its entry (d, 0)."""
    mesh.require_one_process("the mesh forward cut into parts per card")
    D, M = mesh.shape["data"], mesh.shape["model"] if sharded else 1
    grid = mesh.devices if places is None else np.asarray(places, dtype=object).reshape(
        mesh.devices.shape)
    device = {}
    for d in range(D):
        for m in range(mesh.shape["model"]):
            device.setdefault(grid[d, m], mesh.device(d, m))
    order = list(device)
    home = grid[0, 0]
    parts = []
    for p in order:
        shards = tuple((d, m) for d in range(D) for m in range(1, M)
                       if grid[d, m] == p and grid[d, 0] != p)
        if shards:
            parts.append(CardPart(p, device[p], shards, (), False))
    for p in order[1:] + [home]:
        rows = tuple(d for d in range(D) if grid[d, 0] == p)
        if rows or p == home:
            parts.append(CardPart(p, device[p], (), rows, p == home))
    return tuple(parts)


def _direct_fns(model: ModelFns, sp: ShardedParams):
    """The row-sharded lookup's pieces over static inputs ``x`` (a place's
    rows: ``indices``, ``dense``, ``mask`` of the whole bucket): shard
    (d, m)'s partial (a replicated table: row d's whole lookup) and row d's
    finish, as ``sharded_apply`` computes them."""
    from deeprecsys_tpu_torch.models.base import pooled_lookup

    cfg, mesh = model.cfg, sp.mesh
    D = mesh.shape["data"]
    layout, cdt = _layout(sp.first_entry()["tables"]), compute_dtype_of(cfg)
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))
    rps = sp.rows_per_shard
    ranges = None if rps is None else shard_table_ranges(cfg, rps, mesh.shape["model"])

    def rows(x, name, d):
        t = x.get(name)
        b = x["indices"].shape[0] // D
        return None if t is None else t[d * b:(d + 1) * b]

    def partial(d, m, x):
        dev = mesh.device(d, m)
        idx, mask = rows(x, "indices", d), rows(x, "mask", d)
        if rps is None:
            return pooled_lookup(sp.entry(d, 0)["tables"], Batch(dense=None, indices=idx,
                                                                 mask=mask),
                                 cfg, offsets=offsets.on(dev))
        return _shard_partial(layout, sp.entry(d, m)["tables"], offsets.on(dev), idx,
                              m * rps, cdt, mask, ranges[m])

    def finish(d, acc):
        if rps is None:
            return acc
        scale = sp.entry(d, 0)["tables"]["scale"] if layout == "int8" else None
        return _finish(acc, layout, cdt, scale)

    return partial, finish, lambda x, d: rows(x, "dense", d)


def _hotcold_fns(model: ModelFns, sp: ShardedParams):
    """The mesh hot/cold lookup's pieces over static inputs ``x`` (a
    place's split: ``hot_sel``, ``hot_mask``, ``cold_local`` and
    ``cold_seg`` streams, ``dense``): cell (d, m)'s K6 partial, the hot
    hits counted on shard 0, and row d's finish, as
    ``models/hotcold.py``'s mesh apply computes them (tensor-parallel where
    "data" is 1, else hybrid)."""
    cfg, mesh = model.cfg, sp.mesh
    D, T = mesh.shape["data"], cfg.num_tables
    tables0 = sp.first_entry()["tables"]
    key = ("qrows" if isinstance(tables0, dict) and "qrows" in tables0
           else "q" if isinstance(tables0, dict) else None)
    layout = _quant_layout(tables0["scale"] if key == "q" else None, key == "qrows")
    cdt = compute_dtype_of(cfg)

    def rows(x, name, d):
        t = x.get(name)
        b = x["hot_sel"].shape[0] // D
        return None if t is None else t[d * b:(d + 1) * b]

    def partial(d, m, x):
        e = sp.entry(d, m)
        cell = (m,) if D == 1 else (d, m)
        split = {"cold_ids": x["cold_local"][cell], "cold_seg": x["cold_seg"][cell]}
        shard = e["tables"] if key is None else e["tables"][key]
        if m == 0:
            split.update(hot_sel=rows(x, "hot_sel", d), hot_mask=rows(x, "hot_mask", d))
            return _hotcold_shard_partial(layout, e["hot_table"], shard, split, cdt)
        bags = (x["hot_sel"].shape[0] // D, T)
        return _hotcold_shard_partial(layout, None, shard, dict(split, bags=bags), cdt)

    def finish(d, acc):
        scale = sp.entry(d, 0)["tables"]["scale"] if layout == "int8" else None
        return _finish(acc, layout, cdt, scale)

    return partial, finish, lambda x, d: rows(x, "dense", d)


def mesh_stages(model: ModelFns, sp: ShardedParams, plan: tuple, inputs: dict,
                hotcold: bool = False) -> tuple[list, list]:
    """``sharded_apply``'s forward (``hotcold``: the mesh hot/cold model's)
    over ``sp`` as ``plan``'s parts (``card_plan``), each reading the static
    inputs of its place, ``inputs[place]`` (a dict by name, the bucket's
    rows or split). Every tensor a part reads from another card is a
    ``recv`` buffer that the caller fills with the output of the part that
    made it (``Stage.sends``): shard (d, m)'s partial (key ``("partial",
    d, m)``), row d's scores (``("scores", d)``). The sums run in shard
    order and each piece is ``sharded_apply``'s, so the parts together
    compute its scores bit for bit. Returns ``(stages, loads)``: the stages
    in order, and ``(place, name, index)`` for each piece of the host rows
    a place reads (``index`` () for a whole array): what the caller copies
    into ``inputs[place][name][index]`` from ``host[name][index]``."""
    mesh = sp.mesh
    D, M = mesh.shape["data"], mesh.shape["model"]
    if sp.rows_per_shard is None:
        M = 1
    partial, finish, dense_of = (_hotcold_fns if hotcold else _direct_fns)(model, sp)
    sent = {e for p in plan for e in p.shards}  # pooled on another card than their row's
    home = plan[-1].device  # the concat's part
    row_home = {d: p.device for p in plan for d in p.rows}
    reads: dict = {}

    def read(place, name, index):
        reads.setdefault(place, {}).setdefault(name, set()).add(index)

    def read_cell(place, d, m):
        if hotcold:
            for name in ("cold_local", "cold_seg"):
                read(place, name, (m,) if D == 1 else (d, m))
            if m == 0:
                read(place, "hot_sel", d)
                read(place, "hot_mask", d)
        else:
            read(place, "indices", d)
            read(place, "mask", d)

    def stage(part: CardPart) -> Stage:
        x = inputs[part.place]
        for d, m in part.shards:
            read_cell(part.place, d, m)
        for d in part.rows:
            read(part.place, "dense", d)
            for m in range(M):
                if (d, m) not in sent:
                    read_cell(part.place, d, m)

        def fn(recv: dict) -> dict:
            out = {("partial", d, m): partial(d, m, x) for d, m in part.shards}
            scores = {}
            for d in part.rows:
                acc = None
                for m in range(M):
                    p = recv[("partial", d, m)] if (d, m) in sent else partial(d, m, x)
                    acc = p if acc is None else acc + p
                scores[d] = model.apply_from_pooled(
                    sp.entry(d, 0), finish(d, acc),
                    Batch(dense=dense_of(x, d), indices=None, mask=None))
            if part.concat:
                out["out"] = torch.cat([scores[d] if d in scores else recv[("scores", d)]
                                        for d in range(D)], dim=0)
            else:
                out.update((("scores", d), s) for d, s in scores.items())
            return out

        sends = {("partial", d, m): row_home[d] for d, m in part.shards}
        if not part.concat:
            sends.update((("scores", d), home) for d in part.rows)
        return Stage(part.device, fn, sends)

    stages = [stage(part) for part in plan]
    loads = []
    for place, names in reads.items():
        x = inputs[place]
        for name, pieces in names.items():
            if x.get(name) is None:
                continue
            cells = name in ("cold_local", "cold_seg")
            whole = (D * M if cells and D > 1 else M if cells else D)
            if len(pieces) == whole:
                loads.append((place, name, ()))
                continue
            b = x[name].shape[0] // D
            for piece in sorted(pieces):
                index = piece if cells else (slice(piece * b, (piece + 1) * b),)
                loads.append((place, name, index))
    return stages, loads


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
    of this process's devices), each shard's table offsets within it and,
    for per-table int8, its placed tables' scales, on this process's devices
    of that shard's column, and the inverse permutation on each of this
    process's devices. A virtual pad slot's offset is 0: it reads the
    shard's row 0 (JAX ``sharding.py:348-357``); its planned offset, the sum
    of its shard's real rows, may equal the shard's row count.
    ``table_scale``: the ``(T,)`` scales of per-table int8."""

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
        """This process's (data slice d, shard s) cells' lookup inputs on
        entry (d, s)'s device: ``(d, s, ids (b, cap, L), mask or None, the
        placed tables' offsets (cap,), their scales (cap,) or None)``, in
        the order d, then s. ``indices`` and ``mask`` are in the original
        table order; virtual slots get id 0 (and a false mask where there is
        one)."""
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
                if not self.mesh.is_local(d, s):
                    continue
                dev = self.mesh.device(d, s)
                idx = _to(idx_perm[d * b:(d + 1) * b, s * cap:(s + 1) * cap].contiguous(), dev)
                msk = None if mask_perm is None else _to(
                    mask_perm[d * b:(d + 1) * b, s * cap:(s + 1) * cap].contiguous(), dev)
                yield (d, s, idx, msk, self.local_off.part(d, s),
                       None if self.scale is None else self.scale.part(d, s))


def _tablewise_out(shards: Sharded, compute_dtype, rowwise: bool) -> tuple:
    """``(dtype, width)`` of the table-wise shards' pooled rows: the compute
    dtype (f32 by default for int8 shards), and the row's width (a row-wise
    int8 row ends in its f32 scale's 4 bytes)."""
    first = shards.first()
    return (compute_dtype or (torch.float32 if first.dtype == torch.int8 else first.dtype),
            first.shape[-1] - (4 if rowwise else 0))


def _gather_row_cells(mesh: Mesh, d: int, pooled: dict, shape: tuple,
                      dtype: torch.dtype) -> dict | None:
    """Row d's cells ``{s: (b, cap, d)}`` on entry (d, 0)'s process (None in
    every other): the JAX tiled ``all_gather`` over "model". Each other
    process of the row sends its cells of the row, concatenated in shard
    order, in one broadcast over the row's processes, in rank order; a
    process outside row d makes no call for it. ``pooled``: this process's
    cells by (d, s)."""
    row = mesh.row_ranks(d)
    if mesh.rank not in row:
        return None
    dest, M = mesh.rank_of(d, 0), mesh.shape["model"]
    got = {s: pooled[(d, s)] for s in range(M) if (d, s) in pooled} if mesh.rank == dest else {}
    b, cap, width = shape
    for r in row:
        if r == dest:
            continue
        theirs = [s for s in range(M) if mesh.rank_of(d, s) == r]
        buf = (torch.cat([_to(pooled[(d, s)], mesh.home) for s in theirs], dim=1)
               if mesh.rank == r else
               torch.empty((b, len(theirs) * cap, width), dtype=dtype, device=mesh.home))
        buf = mesh.broadcast(buf, r, row)
        if mesh.rank == dest:
            got.update({s: buf[:, i * cap:(i + 1) * cap] for i, s in enumerate(theirs)})
    return got if mesh.rank == dest else None


def tablewise_rows(shard_tables, indices: torch.Tensor, plan: TablewisePlan, *,
                   compute_dtype: torch.dtype | None = None, mask: torch.Tensor | None = None,
                   rowwise: bool = False) -> list:
    """``tablewise_embedding_bag``'s data slices on ``plan``'s mesh: slice
    d's ``(b, T, d)`` pooled lookup on entry (d, 0), for each d; None for a
    slice whose entry (d, 0) another process holds. Each process pools its
    own cells (``plan.cells``); across processes a row's cells cross to
    entry (d, 0)'s process (``_gather_row_cells``) in the order d, then
    rank, the same on every process."""
    from deeprecsys_tpu_torch import ops

    mesh = plan.mesh
    shards = (shard_tables if isinstance(shard_tables, Sharded)
              else Sharded.stacked(shard_tables, mesh))
    cdt, width = _tablewise_out(shards, compute_dtype, rowwise)
    pooled = {}
    for d, s, idx, msk, offs, scale in plan.cells(indices, mask):
        tbl = shards.part(d, s)
        if rowwise:
            pooled[(d, s)] = ops.embedding_bag_int8_rowwise(tbl, offs, idx, compute_dtype=cdt,
                                                            mask=msk)
        elif scale is not None:
            pooled[(d, s)] = ops.embedding_bag_int8(tbl, scale, offs, idx, compute_dtype=cdt,
                                                    mask=msk)
        else:
            pooled[(d, s)] = ops.embedding_bag(tbl, offs, idx, compute_dtype=cdt, mask=msk)
    D, M = mesh.shape["data"], mesh.shape["model"]
    shape = (torch.as_tensor(indices).shape[0] // D, plan.cap, width)
    out = []
    for d in range(D):
        cells = _gather_row_cells(mesh, d, pooled, shape, cdt)
        if cells is None:
            out.append(None)
            continue
        dev0 = mesh.device(d, 0)
        out.append(torch.cat([_to(cells[s], dev0) for s in range(M)], dim=1)
                   .index_select(1, plan.inv.on(dev0)))
    return out


def tablewise_embedding_bag(shard_tables, indices: torch.Tensor, placement, mesh: Mesh, *,
                            compute_dtype: torch.dtype | None = None,
                            mask: torch.Tensor | None = None, table_scale=None,
                            rowwise: bool = False) -> torch.Tensor:
    """Pooled lookup with table-wise sharding (JAX ``sharding.py:311-397``):
    shard s pools only its own tables (the direct kernel of the layout on
    the shard with the tables' offsets within it: K1, K1-int8 with the
    placed tables' ``table_scale``, or K4 with ``rowwise``), the combine is
    a ``torch.cat`` of the shards' ``(b, cap, d)`` slices on entry (d, 0)
    (the JAX ``all_gather``; across processes the row's cells are sent
    there), and the inverse permutation restores the original table order.
    ``indices`` and ``mask`` are in the original order; virtual pad tables
    read the shard's row 0 with a false mask and are dropped.
    ``shard_tables``: ``(M, rows_per_shard, W)`` (``build_tablewise_tables``)
    or its ``Sharded`` shards. Returns ``(B, T, d)`` in the compute dtype on
    ``mesh.home``, on every process."""
    shards = (shard_tables if isinstance(shard_tables, Sharded)
              else Sharded.stacked(shard_tables, mesh))
    out = tablewise_rows(shards, indices, TablewisePlan(placement, mesh, table_scale),
                         compute_dtype=compute_dtype, mask=mask, rowwise=rowwise)
    cdt, width = _tablewise_out(shards, compute_dtype, rowwise)
    B, T = torch.as_tensor(indices).shape[:2]
    return concat_slices(mesh, out, (B // mesh.shape["data"], T, width), cdt)


# ----------------------------------------------------------------------
# Training over a mesh
# ----------------------------------------------------------------------


def leaf_groups(sp: ShardedParams, skip: tuple = ()) -> list:
    """Each logical leaf of this process as ``((path, m), copies)``: its
    distinct tensors, first copy first, where ``m`` is the shard of a
    row-sharded table's leaf (its copies on this process's distinct devices
    of column m) and None for a replicated leaf (a copy a distinct device).
    Top-level keys in ``skip`` are left out. One step updates each tensor
    here once, whichever entries share it."""
    groups: dict = {}
    for row in sp.entries:
        for m, e in enumerate(row):
            if e is None:
                continue
            for path, t in bridge.flatten(e).items():
                top = path.split("/")[0]
                if top in skip:
                    continue
                sharded = top == "tables" and sp.rows_per_shard is not None and t.dim() == 2
                copies = groups.setdefault((path, m if sharded else None), [])
                if not any(c is t for c in copies):
                    copies.append(t)
    return list(groups.items())


def leaf_copies(sp: ShardedParams, skip: tuple = ()) -> list:
    """Each logical leaf's distinct tensors in this process (``leaf_groups``
    without the keys)."""
    return [copies for _, copies in leaf_groups(sp, skip)]


def reduce_copies(mesh: Mesh, groups: list, grads: list) -> list:
    """The gradients of ``groups``' tensors (``leaf_groups``, flattened in
    order; None for a copy no slice used) with each logical leaf's copies
    given their sum: added in copy order on the first copy's device (the
    JAX ``psum``), then, across processes, summed over the processes that
    hold copies of the leaf (every process for a replicated leaf, column
    m's for shard m) by ``reduce_across``: one all-reduce for each set of
    processes and dtype; then moved to each copy's device. A leaf of one
    copy in one process keeps its gradient."""
    totals, i = [], 0
    for _, copies in groups:
        gs = grads[i:i + len(copies)]
        i += len(copies)
        total = None
        for g in gs:
            if g is not None:
                total = _to(g, copies[0].device) if total is None else total + _to(
                    g, copies[0].device)
        totals.append(torch.zeros_like(copies[0]) if total is None else total)
    if mesh.multi_process:
        totals = reduce_across(mesh, [key for key, _ in groups], totals)
    out = []
    for (_, copies), total in zip(groups, totals):
        out.extend(_to(total, c.device) for c in copies)
    return out


def reduce_across(mesh: Mesh, keys: list, totals: list) -> list:
    """Each leaf's total (``keys[j]`` its ``(path, m)``: m None for a
    replicated leaf, the shard for a table's) summed over the processes that
    hold the leaf: ``all_ranks``, or ``col_ranks(m)``. The counterpart of
    XLA's all-reduce combiner: the leaves of one rank set and dtype go
    flattened into one buffer, in the order of their keys, and take one
    all-reduce (``Mesh.all_reduce_flat``), which every member issues in the
    same order (by each buffer's first key: the members of a rank set hold
    the same leaves of it). A leaf of ``PACK_MAX`` elements or more (a table
    shard's dense gradient) takes an all-reduce of its own, as XLA's
    combiner leaves a buffer past its threshold alone. The threshold is the
    cross-card packing constant, assumed here and not measured for this
    use: packing a leaf of that size copies 64 MiB in and out (about 20 µs
    at an H100's 3.35 TB/s), about one NCCL all-reduce's launch, and rm1's
    leaves fall far to either side of it (a table shard's gradient of some
    10^8 elements, tower leaves below 10^6), so any threshold between those
    splits them the same way. A sum of two processes is the same bits
    either way."""
    totals = list(totals)
    buckets: dict = {}
    for j in sorted(range(len(keys)), key=lambda j: (keys[j][0], keys[j][1] or 0)):
        m = keys[j][1]
        ranks = mesh.all_ranks if m is None else mesh.col_ranks(m)
        if len(ranks) == 1:
            continue
        tag = ("alone", j) if totals[j].numel() >= PACK_MAX else totals[j].dtype
        buckets.setdefault((ranks, tag), []).append(j)
    for (ranks, _), js in buckets.items():
        for j, t in zip(js, mesh.all_reduce_flat([totals[j] for j in js], ranks)):
            totals[j] = t
    return totals


def by_device(tensors: list) -> dict:
    """``{device: [indices of tensors on it]}`` in first-seen order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.device, []).append(i)
    return out


def with_grad(leaves: list, fn):
    """``fn()`` with ``leaves`` requiring grad for its duration only, so
    trained params are plain tensors between steps (serving them runs no
    autograd)."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        return fn()
    finally:
        for p in leaves:
            p.requires_grad_(False)


def split_targets(targets: torch.Tensor, mesh: Mesh) -> list:
    """The targets' D contiguous slices over "data", slice d on entry (d, 0)
    (None where another process holds it)."""
    D = mesh.shape["data"]
    b = targets.shape[0] // D
    return [_to(targets[d * b:(d + 1) * b], mesh.device(d, 0)) if mesh.is_local(d, 0) else None
            for d in range(D)]


def mesh_loss(model: ModelFns, sp: ShardedParams, slices: list, targets: list, loss_fn,
              pooled_of: Callable) -> tuple:
    """The global mean loss: each data slice's mean loss (``pooled_of(d,
    slice)``, then ``apply_from_pooled`` on entry (d, 0)), summed on
    ``mesh.home`` in slice order and divided by D (the JAX ``pmean`` over
    "data"; equal slices, so the mean of the batch). Returns ``(share,
    loss)``: ``share`` is what this process differentiates, the sum of the
    slices whose entry (d, 0) it holds over D (None if it holds none);
    ``loss`` is what every process returns: across processes the slices'
    losses gathered (an all-reduce of a (D,) vector holding each at its
    row and zeros elsewhere, so exact), then summed as on one process. On
    one process both are the one loss."""
    mesh = sp.mesh
    D = len(slices)
    losses = {}
    for d, sl in enumerate(slices):
        if not mesh.is_local(d, 0):
            continue
        dev0 = mesh.device(d, 0)
        tail = Batch(dense=None if sl.dense is None else _to(torch.as_tensor(sl.dense), dev0),
                     indices=None, mask=None)
        loss = loss_fn(model.apply_from_pooled(sp.entry(d, 0), pooled_of(d, sl), tail),
                       targets[d])
        losses[d] = _to(loss, mesh.home)

    def mean(ls):
        total = None
        for loss in ls:
            total = loss if total is None else total + loss
        return None if total is None else total / D

    share = mean(losses.values())
    if not mesh.multi_process:
        return share, share
    # Made on the card from the losses (no host read), so a step that holds
    # it can be captured.
    zero = torch.zeros((), dtype=torch.float32, device=mesh.home)
    vec = torch.stack([losses[d].detach().float() if d in losses else zero for d in range(D)])
    vec = mesh.all_reduce(vec, mesh.all_ranks)
    return share, mean(vec[d] for d in range(D))


class MeshOptimizer:
    """An optimizer (``ops/optimizer.py::Optimizer``) over the distinct
    tensors of a mesh's params: a state a device (its tensors', in
    ``leaf_copies`` order), one update (one K10 launch a dtype) a device.
    Each tensor's state has its shape, so a row shard's state is row-sharded
    with it and every other leaf's is replicated (JAX ``train.py:375-386``)."""

    def __init__(self, tx, leaves: list):
        self.tx = tx
        self.devices = by_device(leaves)
        self.states = {dev: tx.init([leaves[i] for i in idx])
                       for dev, idx in self.devices.items()}

    def update(self, leaves: list, grads: list):
        for dev in self.devices:
            self.update_on(dev, leaves, grads)

    def update_on(self, dev: torch.device, leaves: list, grads: list):
        """The update of ``dev``'s tensors alone (``grads`` is read only at
        their indices): a training step cut by card runs it on each card."""
        idx = self.devices[dev]
        self.tx.update([leaves[i] for i in idx], [grads[i].to(leaves[i].dtype) for i in idx],
                       self.states[dev])


def make_mesh_dense_step(model: ModelFns, mesh: Mesh, loss_fn) -> Callable:
    """The dense step over a mesh (JAX ``Trainer._build_step`` with
    shardings, ``train.py:354-399``): autodiff through the row-sharded
    lookup (each shard's partial an ``EmbeddingBagShardFunction``: K1's
    window forward, K1b's window backward) and the towers, the loss the mean
    of the slices' means, each leaf's gradient summed over its copies
    (``reduce_copies``), then the optimizer (``MeshOptimizer``, K10).
    ``step(sp, opt_state, batch, targets)`` updates both in place and
    returns the loss; ``opt_state`` is a ``MeshOptimizer`` of
    ``leaf_copies(sp)``' tensors.

    A row whose entries several processes hold is differentiated in two
    passes: each process's part of the row (``row_partial``) is summed over
    the row's processes, and entry (d, 0)'s process differentiates its loss
    with respect to that sum; the sum's backward is then a broadcast of
    the row's pooled gradient from there to the row's processes, each of
    which runs its windows' backward with it (K1b's window). The collectives
    run between the passes, in row order: inside autograd each process's
    engine would order them by its own graph, which differs between
    processes. A row within one process is one pass, as on one process."""
    cfg = model.cfg
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))

    def step(sp: ShardedParams, opt_state: MeshOptimizer, batch: Batch, targets):
        groups = leaf_groups(sp)
        leaves = [t for _, copies in groups for t in copies]
        slices, tsl = split_batch(batch, mesh), split_targets(targets, mesh)

        def run():
            pooled, parts, sums = {}, {}, {}
            for d, sl in enumerate(slices):
                if sp.rows_per_shard is None or len(mesh.row_ranks(d)) == 1:
                    pooled[d] = pooled_on_row(sp, d, sl, cfg, offsets)
                    continue
                part, finish = row_partial(sp, d, sl, cfg, offsets)
                if part is None:
                    continue
                parts[d] = part
                total = _row_sum(mesh, d, part.detach())
                if total is not None:
                    sums[d] = total.requires_grad_()
                    pooled[d] = finish(sums[d])
            share, loss = mesh_loss(model, sp, slices, tsl, loss_fn, lambda d, sl: pooled[d])
            n = len(leaves)
            grads = (torch.autograd.grad(share, leaves + list(sums.values()), allow_unused=True)
                     if share is not None else (None,) * (n + len(sums)))
            if not parts:
                return loss, grads[:n]
            g_sums = dict(zip(sums, grads[n:]))
            g_parts = [mesh.broadcast(g_sums[d] if d in g_sums else torch.empty_like(p),
                                      mesh.rank_of(d, 0), mesh.row_ranks(d)).to(p.device)
                       for d, p in parts.items()]
            more = torch.autograd.grad(list(parts.values()), leaves, g_parts, allow_unused=True)
            return loss, [a if b is None else b if a is None else a + b
                          for a, b in zip(grads[:n], more)]

        loss, grads = with_grad(leaves, run)
        opt_state.update(leaves, reduce_copies(mesh, groups, list(grads)))
        return loss.detach()

    def stages(sp: ShardedParams, opt_state: MeshOptimizer, inputs: dict,
               places: "TrainPlaces") -> list:
        return mesh_train_stages(model, sp, loss_fn, opt_state, inputs, places)

    step.stages = stages
    return step


# ----------------------------------------------------------------------
# A training step cut into parts by card (the trainers' staged programs)
# ----------------------------------------------------------------------


class TrainPlaces(NamedTuple):
    """Where the parts of a one-process mesh's training step run
    (``train_places``): ``grid`` maps each entry (d, m) to its place,
    ``devices`` each place to its device (in the entries' row-major order),
    ``home`` is entry (0, 0)'s place."""

    grid: dict
    devices: dict
    home: object

    def order(self, places) -> list:
        """``places`` in the entries' order, home last: the order in which
        the parts of one kind run."""
        return [p for p in self.devices if p in places and p != self.home] + (
            [self.home] if self.home in places else [])


def train_places(mesh: Mesh) -> TrainPlaces:
    """Each entry's place, read from the forward's cut (``card_plan``, so
    that a plan which labels the entries labels the step's parts too): a
    shard the plan sends is pooled on its own card, every other entry on its
    row's. A step over more than one place is cut into parts
    (``mesh_train_stages``)."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    plan = card_plan(mesh)
    grid, device = {}, {p.place: p.device for p in plan}
    for part in plan:
        for e in part.shards:
            grid[e] = part.place
    for part in plan:
        for d in part.rows:
            for m in range(M):
                grid.setdefault((d, m), part.place)
    devices: dict = {}
    for d in range(D):
        for m in range(M):
            devices.setdefault(grid[(d, m)], device[grid[(d, m)]])
    return TrainPlaces(grid, devices, grid[(0, 0)])


class TableStep(NamedTuple):
    """The sparse step's table update as its cut runs it (``train.py``'s
    pieces): ``acc`` the row accumulator (row-sharded with the table);
    ``stream(offsets, ids, g)`` K5's stream (``dedup``'s merged rows, or as
    it is); ``update(table, acc, offsets, ids, g, row_lo)`` K5's window on a
    shard's first copy; ``rows(table, acc, offsets, ids, row_lo)`` the
    fixed-size touched rows ``(rows, table rows, acc rows)`` that
    ``set_rows(tables, accs, rows, table rows, acc rows)`` writes into the
    other copies."""

    acc: Sharded
    stream: Callable
    update: Callable
    rows: Callable
    set_rows: Callable


# A value a part sends another card crosses alone from this many elements
# (a table shard's gradient); smaller ones to one card go packed into one
# flat tensor a dtype, one cross-card copy instead of one a leaf. Across
# processes the same size sets a gradient's all-reduce apart
# (``reduce_across``).
PACK_MAX = 1 << 22


class _Mail:
    """The values the parts of one step hand each other, by (place, key).
    One for a later part of its own place stays in ``local``; one for
    another place goes out in the part's outputs (``Stage.sends``), packed
    (``PACK_MAX``), and is read there from the receive buffers as a view."""

    def __init__(self, places: TrainPlaces):
        self.devices = places.devices
        self.local: dict = {}  # (place, key) -> tensor
        self.where: dict = {}  # (place, key) -> (receive key, shape, start, numel)

    def stage(self, place, kind: str, body: Callable) -> Stage:
        """The part ``kind`` of ``place``: ``body(get, put)`` runs its work,
        reads what was sent to it by ``get(key)`` (None if nothing was) and
        sends by ``put(place, key, tensor)`` (a None tensor sends nothing);
        it returns its other outputs (``"out"``: the step's loss)."""
        sends: dict = {}

        def fn(recv: dict) -> dict:
            mail: dict = {}

            def put(dst, key, t):
                if t is None:
                    return
                if dst == place:
                    self.local[(place, key)] = t
                else:
                    mail.setdefault(dst, []).append((key, t))

            outs = body(lambda key: self._get(place, key, recv), put) or {}
            for dst, items in mail.items():
                packs: dict = {}
                for key, t in items:
                    if t.numel() >= PACK_MAX:
                        packs[("alone", key)] = [(key, t)]
                    else:
                        packs.setdefault(t.dtype, []).append((key, t))
                for tag, group in packs.items():
                    rkey = (kind, place, dst, str(tag))
                    at = 0
                    for key, t in group:
                        self.where[(dst, key)] = (rkey, tuple(t.shape), at, t.numel())
                        at += t.numel()
                    outs[rkey] = (group[0][1] if len(group) == 1
                                  else torch.cat([t.reshape(-1) for _, t in group]))
                    sends[rkey] = self.devices[dst]
            return outs

        return Stage(self.devices[place], fn, sends, (kind, place))

    def _get(self, place, key, recv: dict):
        t = self.local.get((place, key))
        if t is not None:
            return t
        at = self.where.get((place, key))
        if at is None:
            return None
        rkey, shape, start, n = at
        buf = recv[rkey]
        return buf.view(shape) if buf.numel() == n else buf[start:start + n].view(shape)


def mesh_train_stages(model: ModelFns, sp: ShardedParams, loss_fn, opt: MeshOptimizer,
                      inputs: dict, places: TrainPlaces, tables: TableStep | None = None) -> list:
    """One training step over ``sp`` (one process, several places) cut into
    parts, each the work of one place (``Stage``: it reads only tensors on
    its own card, so that it can be captured as a CUDA graph of that card).
    ``inputs[place]``: the whole batch's static tensors there (``dense``,
    ``indices``, ``mask``, ``targets``). ``tables`` None: the dense step
    (``make_mesh_dense_step``), the optimizer over every tensor; else the
    sparse step (``train.py::make_sharded_sparse_table_step``), the
    optimizer over the towers and ``tables`` for the table. The kinds of
    part run in this order, each kind's parts home last:

    1. shard: K1's window on each entry whose row is combined on another
       place, without grad; the partial sent to entry (d, 0)'s place;
    2. row: on each place that holds rows' first entries, each row's sum
       over "model" in shard order (its own partials, the dense step's
       through ``EmbeddingBagShardFunction``, and the received ones, leaves
       of the autograd graph there), its finish, tail and loss; the rows'
       losses over D differentiated with respect to the towers of those
       entries and its own shards (dense) or the pooled rows (sparse), and
       to the received partials, whose gradients go back to their shards'
       places (dense); the losses go to home; the pooled gradients (sparse)
       to each entry (0, m)'s place;
    3. backward (dense): K1b's window on each sent shard, from its received
       gradient;
    4. reduce: each leaf's copies' gradients (each the sum of its parts'
       contributions, in part order) added on its first copy's place in
       copy order (``reduce_copies``), the sum sent to every copy's place;
       a leaf of one copy and at most one contribution has nothing to add,
       and its gradient goes straight to its update;
    5. update: ``MeshOptimizer.update_on`` of a device (K10); sparse, K5's
       window on each entry (0, m)'s place over every slice's ids and
       pooled gradients in data-row order (``tables.update``) and its
       touched rows for the shard's other copies (``tables.rows``); home
       sums the losses in slice order over D (``"out"``);
    6. copy (sparse): those rows written into the other copies.

    Each piece and its order is the eager step's, so the parts, run in
    order with their sends, give its loss and its updates bit for bit
    where no tensor takes more than two contributions (a place's copies are
    distinct tensors on distinct cards; entries labelled as places on one
    device share them)."""
    from deeprecsys_tpu_torch.models.base import pooled_lookup
    from deeprecsys_tpu_torch.ops import embedding as emb

    mesh, cfg = sp.mesh, model.cfg
    D = mesh.shape["data"]
    rps = sp.rows_per_shard
    M = 1 if rps is None else mesh.shape["model"]
    sparse = tables is not None
    grid, devices, home = places.grid, places.devices, places.home
    layout, cdt = _layout(sp.first_entry()["tables"]), compute_dtype_of(cfg)
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))
    ranges = None if rps is None else shard_table_ranges(cfg, rps, mesh.shape["model"])
    groups = leaf_groups(sp, skip=("tables",) if sparse else ())
    leaves = [t for _, copies in groups for t in copies]
    index = {id(t): i for i, t in enumerate(leaves)}
    home_of: dict = {}  # leaf -> the place of the first entry that holds it
    for d in range(D):
        for m in range(mesh.shape["model"]):
            for t in bridge.flatten(sp.entry(d, m)).values():
                if id(t) in index:
                    home_of.setdefault(index[id(t)], grid[(d, m)])
    first = 0
    reduce_at, copies_of = {}, {}  # leaf -> its group's first copy's place; group -> leaves
    for j, (_, copies) in enumerate(groups):
        copies_of[j] = list(range(first, first + len(copies)))
        for i in copies_of[j]:
            reduce_at[i] = home_of[first]
        first += len(copies)
    update_at = {dev: home_of[idx[0]] for dev, idx in opt.devices.items()}
    update_of = {i: update_at[leaves[i].device] for i in range(len(leaves))}
    sent = [(d, m) for d in range(D) for m in range(M) if grid[(d, m)] != grid[(d, 0)]]
    rows_at: dict = {}
    for d in range(D):
        rows_at.setdefault(grid[(d, 0)], []).append(d)
    k5_at = sorted({grid[(0, m)] for m in range(M)}, key=list(devices).index) if sparse else []
    mail = _Mail(places)

    def rows_of(x, name, d):
        t = x.get(name)
        b = x["indices"].shape[0] // D
        return None if t is None else t[d * b:(d + 1) * b]

    def mask_of(x, d):
        return None if sparse else rows_of(x, "mask", d)

    def used_by(rows) -> list:
        """The tensors a row part differentiates: the towers of its rows'
        entries (d, 0), and the shards it pools (dense)."""
        out, seen = [], set()
        for d in rows:
            ts = [t for path, t in bridge.flatten(sp.entry(d, 0)).items()
                  if not (sparse and path.split("/")[0] == "tables")]
            if not sparse and rps is not None:
                ts += [sp.entry(d, m)["tables"] for m in range(1, M) if (d, m) not in sent]
            for t in ts:
                if id(t) in index and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    contrib: dict = {}  # leaf -> the keys of its gradient's contributions, in part order
    alone: set = set()  # leaves of one copy and at most one contribution: no reduce
    stages = []

    def grad_to(i, key) -> tuple:
        """Where a contribution to leaf i goes, and its key there: the
        leaf's reduce, or, alone, straight to its update as its total."""
        return (update_of[i], ("total", i)) if i in alone else (reduce_at[i], key)

    def shard_part(p):
        def body(get, put):
            x, off = inputs[p], offsets.on(devices[p])
            for d, m in [e for e in sent if grid[e] == p]:
                with torch.no_grad():
                    part = _shard_partial(layout, sp.entry(d, m)["tables"], off,
                                          rows_of(x, "indices", d), m * rps, cdt, mask_of(x, d),
                                          ranges[m])
                put(grid[(d, 0)], ("partial", d, m), part)
        return body

    def row_part(p, rows):
        used = used_by(rows)
        keys = [("g", index[id(t)], p) for t in used]
        for t, key in zip(used, keys):
            contrib.setdefault(index[id(t)], []).append(key)

        def body(get, put):
            x = inputs[p]
            off = offsets.on(devices[p])
            received = []  # dense: ((d, m), the received partial as a leaf)

            def lookup(d):
                idx, msk = rows_of(x, "indices", d), mask_of(x, d)
                if rps is None:  # a replicated table: the whole lookup on entry (d, 0)
                    return pooled_lookup(sp.entry(d, 0)["tables"],
                                         Batch(dense=None, indices=idx, mask=msk), cfg, offsets=off)
                acc = None
                for m in range(M):
                    if (d, m) in sent:
                        part = get(("partial", d, m))
                        if not sparse:
                            part = part.detach().requires_grad_()
                            received.append(((d, m), part))
                    else:
                        part = _shard_partial(layout, sp.entry(d, m)["tables"], off, idx,
                                              m * rps, cdt, msk, ranges[m])
                    acc = part if acc is None else acc + part
                return _finish(acc, layout, cdt)

            pooled = {}
            if sparse:
                with torch.no_grad():
                    pooled = {d: lookup(d) for d in rows}
            wrt = used + list(pooled.values())

            def run():
                losses, share = {}, None
                for d in rows:
                    tail = Batch(dense=rows_of(x, "dense", d), indices=None, mask=None)
                    scores = model.apply_from_pooled(sp.entry(d, 0),
                                                     pooled[d] if sparse else lookup(d), tail)
                    losses[d] = loss_fn(scores, rows_of(x, "targets", d))
                    share = losses[d] if share is None else share + losses[d]
                return losses, torch.autograd.grad(share / D, wrt + [r for _, r in received],
                                                   allow_unused=True)

            losses, grads = with_grad(wrt, run)
            for d in rows:
                put(home, ("loss", d), losses[d].detach())
            for t, key, g in zip(used, keys, grads):
                put(*grad_to(index[id(t)], key), g)
            rest = grads[len(used):]
            for d, g in zip(rows, rest[:len(pooled)]):
                for q in k5_at:
                    put(q, ("pooled grad", d), g)
            for ((d, m), _), g in zip(received, rest[len(pooled):]):
                put(grid[(d, m)], ("partial grad", d, m), g)
        return body

    def backward_part(p):
        mine = [e for e in sent if grid[e] == p]
        for d, m in mine:
            contrib.setdefault(index[id(sp.entry(d, m)["tables"])], []).append(("g", p, d, m))

        def body(get, put):
            x, off = inputs[p], offsets.on(devices[p])
            for d, m in mine:
                shard = sp.entry(d, m)["tables"]
                g = emb.embedding_bag_backward_shard(
                    get(("partial grad", d, m)), off, rows_of(x, "indices", d), m * rps,
                    shard.shape[0], mask=mask_of(x, d), table_range=ranges[m])
                put(*grad_to(index[id(shard)], ("g", p, d, m)), g.to(shard.dtype))
        return body

    def reduce_part(p):
        mine = [j for j, copies in copies_of.items()
                if reduce_at[copies[0]] == p and copies[0] not in alone]

        def body(get, put):
            for j in mine:
                total = None
                for i in copies_of[j]:
                    g_copy = None
                    for key in contrib.get(i, ()):
                        g = get(key)
                        if g is not None:
                            g_copy = g if g_copy is None else g_copy + g
                    if g_copy is not None:
                        total = g_copy if total is None else total + g_copy
                if total is None:
                    total = torch.zeros_like(leaves[copies_of[j][0]])
                for i in copies_of[j]:
                    put(update_of[i], ("total", i), total)
        return body

    def update_part(p):
        mine = [dev for dev, q in update_at.items() if q == p]
        shards = [m for m in range(M) if sparse and grid[(0, m)] == p]

        def body(get, put):
            grads = [None] * len(leaves)
            for dev in mine:
                for i in opt.devices[dev]:
                    g = get(("total", i))  # None: a leaf alone that no part used
                    grads[i] = torch.zeros_like(leaves[i]) if g is None else g
                opt.update_on(dev, leaves, grads)
            if shards:
                x, off = inputs[p], offsets.on(devices[p])
                g = torch.cat([get(("pooled grad", d)) for d in range(D)])
                stream = tables.stream(off, x["indices"], g)
                for m in shards:
                    copies = shard_copies(sp, tables.acc, m)
                    (_, t0, a0), rest = copies[0], copies[1:]
                    tables.update(t0, a0, *stream, m * rps)
                    if rest:
                        moved = tables.rows(t0, a0, stream[0], stream[1], m * rps)
                        for d, _, _ in rest:
                            for n, t in enumerate(moved):
                                put(grid[(d, m)], ("rows", m, d, n), t)
            if p == home:
                loss = None
                for d in range(D):
                    loss = get(("loss", d)) if loss is None else loss + get(("loss", d))
                return {"out": loss / D}
        return body

    def copy_part(p):
        mine = [(m, d, t, a) for m in range(M) for d, t, a in shard_copies(sp, tables.acc, m)[1:]
                if grid[(d, m)] == p]

        def body(get, put):
            for m, d, t, a in mine:
                tables.set_rows([t], [a], *(get(("rows", m, d, n)) for n in range(3)))
        return body

    def kind(name, parts: dict):
        for p in places.order(parts):
            stages.append(mail.stage(p, name, parts[p]))

    kind("shard", {grid[e]: shard_part(grid[e]) for e in sent})
    kind("row", {p: row_part(p, rows) for p, rows in rows_at.items()})
    if not sparse:
        kind("backward", {grid[e]: backward_part(grid[e]) for e in sent})
    alone.update(i for i, *more in copies_of.values()
                 if not more and len(contrib.get(i, ())) <= 1)
    kind("reduce", {reduce_at[copies[0]]: reduce_part(reduce_at[copies[0]])
                    for copies in copies_of.values() if copies[0] not in alone})
    kind("update", {p: update_part(p) for p in set(update_at.values()) | set(k5_at)})
    if sparse:
        kind("copy", {grid[(d, m)]: copy_part(grid[(d, m)]) for m in range(M)
                      for d, _, _ in shard_copies(sp, tables.acc, m)[1:]})
    return stages


def shard_copies(sp: ShardedParams, acc: Sharded, m: int) -> list:
    """Shard m's distinct copies in this process, first copy first: ``(d,
    table, acc)`` of the first row d that holds each (the sparse step's
    table and its row accumulator)."""
    out = []
    for d in range(sp.mesh.shape["data"]):
        e = sp.entry(d, m)
        if e is not None and not any(e["tables"] is t for _, t, _ in out):
            out.append((d, e["tables"], acc.part(d, m)))
    return out


def _check_dense(has_dense: bool, batch: Batch):
    if has_dense != (batch.dense is not None):
        raise ValueError(f"has_dense={has_dense} but the batch "
                         f"{'has no' if batch.dense is None else 'has'} dense features")


def make_train_step(model: ModelFns, mesh: Mesh, has_dense: bool, learning_rate: float = 0.01,
                    loss: str = "mse", sigmoid_output: bool = True) -> Callable:
    """An SGD train step over the mesh (JAX ``sharding.py:465-499``).

    Takes the ``ModelFns`` (as ``sharded_apply`` does; JAX takes
    ``model.apply``) and returns ``jitted(sp) -> step``, where ``step(sp,
    batch, targets) -> (sp, loss)`` updates ``sp`` (``shard_params``'
    output) in place and returns it. It is ``make_mesh_dense_step`` with
    sgd: the update is JAX's ``p - lr * g.astype(p.dtype)`` in ``p.dtype``,
    computed by K10's sgd (``p += g * -lr``, the same bits: a negation is
    exact), one launch a device and dtype over the distinct tensors there.
    ``sigmoid_output`` tells "bce" which space the scores are in
    (``loss_fn_for``).

    As JAX compiles the step, ``jitted(sp)`` runs it through
    ``train_programs.StepPrograms`` bound to ``sp`` (on a card a CUDA graph
    a batch shape, replayed on the programs' stream; over several cards a
    graph a part of the step, ``mesh_train_stages``), unless
    ``train_programs.eager_reason(mesh)`` keeps it eager (any mesh across
    processes: over gloo, or a process with several cards, it cannot be
    captured; over nccl, a card each, it replays slower); the step then
    takes that ``sp`` only."""
    from deeprecsys_tpu_torch.ops.optimizer import Optimizer
    from deeprecsys_tpu_torch.train_programs import StepPrograms, eager_reason, train_cut

    dense_step = make_mesh_dense_step(model, mesh, loss_fn_for(loss, sigmoid_output))

    def jitted(sp: ShardedParams) -> Callable:
        opt = MeshOptimizer(Optimizer("sgd", learning_rate),
                            [t for copies in leaf_copies(sp) for t in copies])
        programs = None if eager_reason(mesh) else StepPrograms(
            lambda batch, targets: dense_step(sp, opt, batch, targets), mesh.home,
            cut=train_cut(mesh, lambda inputs, places: dense_step.stages(sp, opt, inputs,
                                                                         places)))

        def step(sp_in: ShardedParams, batch: Batch, targets: torch.Tensor):
            _check_dense(has_dense, batch)
            if sp_in is not sp:
                raise ValueError("the step takes the ShardedParams it was built for "
                                 "(make_train_step(...)(sp)); build one for these")
            if programs is not None:
                return sp, programs(batch, targets)
            return sp, dense_step(sp, opt, batch, torch.as_tensor(targets))

        step.programs = programs
        return step

    return jitted


def unshard_params(sp: ShardedParams, device: torch.device | str = "cpu") -> dict:
    """The full params as one device reads them (the counterpart of
    ``np.asarray`` on the JAX package's sharded arrays): the row shards of
    the table concatenated in shard order, every other leaf this process's
    first entry's copy; a copy on ``device`` (the host by default). Across
    processes every process calls it (each shard is broadcast from entry
    (0, m)'s process) and every process gets the whole params; one of them
    (rank 0) writes checkpoints and exports."""
    mesh = sp.mesh
    out = bridge.tree_map(lambda t: t.detach().to(device, copy=True), sp.first_entry())
    if sp.rows_per_shard is not None:
        mine: dict = {}  # shard m -> this process's first copy of it
        for row in sp.entries:
            for m, e in enumerate(row):
                if e is not None:
                    mine.setdefault(m, e["tables"])
        like = next(iter(mine.values()))
        parts = []
        for m in range(mesh.shape["model"]):
            part = mesh.broadcast(mine[m] if m in mine else torch.empty_like(like),
                                  mesh.rank_of(0, m), mesh.all_ranks)
            parts.append(part.detach().to(device))
        out["tables"] = torch.cat(parts)
    return out


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
