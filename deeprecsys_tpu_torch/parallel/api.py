"""Model-level table-wise sharding (counterpart of
``deeprecsys_tpu/parallel/api.py``).

``make_tablewise_model`` lifts any model family onto table-wise-sharded
tables: the fused table converts to the ``(M, rows_per_shard, W)``
placement layout, shard s lives on column s of the mesh, lookups run
through ``tablewise_rows`` (each shard pools only its own tables; a
``torch.cat`` combines), and the rest of the network runs from the pooled
embeddings (``apply_from_pooled``), data-parallel over "data". Across
processes each process places and pools its own shards, a row's cells go to
entry (d, 0)'s process, and the scores are gathered on every process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deeprecsys_tpu_torch.models.base import Batch, ModelFns, compute_dtype_of
from deeprecsys_tpu_torch.parallel.mesh import Mesh
from deeprecsys_tpu_torch.parallel.placement import TablePlacement, plan_tablewise_placement
from deeprecsys_tpu_torch.parallel.sharding import (
    Sharded, TablewisePlan, _to, build_tablewise_tables, concat_slices, split_batch,
    tablewise_rows)


class TablewiseModel(NamedTuple):
    placement: TablePlacement
    convert_params: Callable  # standard params -> table-wise params
    apply: Callable           # (tw_params, Batch) -> scores


def make_tablewise_model(model: ModelFns, mesh: Mesh,
                         placement: TablePlacement | None = None) -> TablewiseModel:
    """The table-wise variant of ``model`` on ``mesh`` (JAX ``api.py:31``).
    ``convert_params`` takes float, per-table int8 (``{"q", "scale"}``) or
    row-wise int8 (``{"qrows"}``) tables and returns ``{"tables_tw":
    Sharded, "plan": TablewisePlan (with the per-table int8 scales), "rest":
    [the other params on entry (d, 0) for each d, None where another process
    holds it]}``, so a forward moves nothing but its batch; ``apply(tw_params,
    batch)`` returns the whole batch's scores on ``mesh.home``, on every
    process (the same batch on every process): per-table int8 pools exactly
    in int32 and scales by each original table's scale, row-wise int8 sums
    the dequantized rows in f32, each cast once, as on one device. Across
    processes each builds the ``(M, rows_per_shard, W)`` layout and places
    its own shards."""
    cfg = model.cfg
    if placement is None:
        placement = plan_tablewise_placement(cfg, mesh.shape["model"])
    quant = cfg.table_quant
    cdt = compute_dtype_of(cfg)

    def convert_params(params: dict) -> dict:
        tables = params["tables"]
        fused = tables["qrows"] if quant == "int8_rowwise" else (
            tables["q"] if quant == "int8" else tables)
        tw = Sharded.stacked(build_tablewise_tables(fused, cfg, placement), mesh)
        rest = [{k: _tree_to(v, mesh.device(d, 0)) for k, v in params.items() if k != "tables"}
                if mesh.is_local(d, 0) else None for d in range(mesh.shape["data"])]
        plan = TablewisePlan(placement, mesh, tables["scale"] if quant == "int8" else None)
        return {"tables_tw": tw, "plan": plan, "rest": rest}

    def apply(tw_params: dict, batch: Batch) -> torch.Tensor:
        pooled = tablewise_rows(tw_params["tables_tw"], torch.as_tensor(batch.indices),
                                tw_params["plan"], compute_dtype=cdt,
                                mask=None if batch.mask is None else torch.as_tensor(batch.mask),
                                rowwise=quant == "int8_rowwise")
        scores, slices = [], split_batch(batch, mesh)
        for d, sl in enumerate(slices):
            if pooled[d] is None:
                scores.append(None)
                continue
            dev = mesh.device(d, 0)
            tail = Batch(dense=None if sl.dense is None else _to(torch.as_tensor(sl.dense), dev),
                         indices=None, mask=None)
            scores.append(model.apply_from_pooled(tw_params["rest"][d], pooled[d], tail))
        return concat_slices(mesh, scores, (slices[0].indices.shape[0], cfg.out_dim), cdt)

    return TablewiseModel(placement=placement, convert_params=convert_params, apply=apply)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return _to(tree, device)
