"""Hot/cold-split serving for any model family.

Counterpart of ``deeprecsys_tpu/models/hotcold.py``. ``make_hotcold_model``
turns a model into a serving variant whose lookup runs through a hot/cold
split: on the host, per request, ``prepare`` splits the batch's lookups
into hits of a hot set of rows and a compacted cold stream (the native C++
splitter of ``runtime/``); on the card, ``apply`` runs K6
(``ops/embedding.py::embedding_bag_hotcold`` and its int8 siblings), which
pools the hits from a ``(K, d)`` copy of the hot rows and the cold stream
from the full table, then the model's own ``apply_from_pooled``.

The JAX package splits because a TPU's gather is bound by its descriptor
rate and its VMEM is managed by software. An H100 keeps hot rows in its
50 MB L2 on its own, so whether the split pays on this card is a
measurement (``experiments/skew_bench.py``, PERF.md), and
``embedding_impl="auto"`` keeps the JAX package's rule.

With ``mesh=`` the variant runs row-sharded (JAX :86-273): the host
partitions the cold stream by owning row shard (``split_hot_cold_sharded``,
the tensor-parallel mode, when the mesh's "data" axis is 1) or by (data
shard, row shard) cell (``split_hot_cold_hybrid`` otherwise), each shard
runs K6 on its own cold stream with the hot hits counted on one shard, and
one sum a data row combines (``parallel/sharding.py``). ``apply`` then takes
``shard_params(convert_params(params), mesh)``. The port keeps ``(R, d)``
tables, so there is no packed cold table.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from deeprecsys_tpu_torch.models.base import Batch, ModelFns, compute_dtype_of
from deeprecsys_tpu_torch.ops.hotcold import (
    select_hot_ids, split_hot_cold, split_hot_cold_hybrid, split_hot_cold_sharded)


def cold_ladder(n_lookups: int) -> tuple[int, ...]:
    """Pad buckets for the cold count: n/8, n/4, n/2, n (ascending,
    deduplicated, at least 8; JAX :51)."""
    steps = sorted({max(8, -(-n_lookups // 8)), max(8, -(-n_lookups // 4)),
                    max(8, -(-n_lookups // 2)), max(8, n_lookups)})
    return tuple(steps)


def cold_buckets_for(n_lookups: int, mesh=None) -> tuple[int, ...]:
    """The cold stream's pad ladder (JAX :60-73). On a mesh the splits pad
    each partition cell (M for tensor-parallel, D*M for hybrid), so the
    ladder is a cell's share of the lookups, plus one cap bucket (the most
    a cell can hold: its data shard's lookups)."""
    if mesh is None:
        return cold_ladder(n_lookups)
    n_data = mesh.shape.get("data", 1)
    parts = n_data * mesh.shape["model"]
    cap = -(-n_lookups // n_data)
    n_cell = -(-n_lookups // parts)
    return tuple(sorted(set(cold_ladder(n_cell)) | {max(8, cap)}))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class HotColdModel(NamedTuple):
    base: ModelFns
    hot_ids: np.ndarray            # sorted fused row ids (host)
    convert_params: Callable       # params -> params + "hot_table"
    apply: Callable                # (params, batch, split tensors) -> scores
    prepare: Callable              # host: Batch -> split dict (padded, numpy)


def make_hotcold_model(model: ModelFns, hot_ids: np.ndarray, mesh=None,
                       hot_index=None) -> HotColdModel:
    """The hot/cold variant of ``model`` for the hot set ``hot_ids``
    (sorted fused row ids; JAX :84). ``hot_index``: a
    ``runtime.native.HotIndex`` over the same ids, built elsewhere (an
    engine's scan worker); else one is built here when the native library
    is available. The closure holds it, so an in-flight ``prepare`` keeps
    it alive across a hot-set swap. With ``mesh`` (JAX :86-99) the total
    rows must divide over the model axis."""
    cfg = model.cfg
    offsets_np = np.asarray(cfg.table_offsets, dtype=np.int64)
    if hot_index is not None and hot_index.K != len(hot_ids):
        raise ValueError(f"prebuilt hot_index covers {hot_index.K} ids, hot set has "
                         f"{len(hot_ids)}")
    if hot_index is None:
        try:
            from deeprecsys_tpu_torch.runtime.native import HotIndex

            hot_index = HotIndex(hot_ids)
        except RuntimeError:
            pass  # no native runtime: the splitter takes its numpy path
    if mesh is not None:
        n_data, n_shards = mesh.shape["data"], mesh.shape["model"]
        if cfg.total_rows % n_shards:
            raise ValueError(f"total rows {cfg.total_rows} must divide over model axis "
                             f"{n_shards}")
        rows_per_shard = cfg.total_rows // n_shards

    def convert_params(params: dict) -> dict:
        """``params`` plus ``"hot_table"``: the hot rows of the table's
        layout, a new tensor gathered on the table's device (the live one
        is never written)."""
        tables = params["tables"]
        if isinstance(tables, dict):
            if set(tables) not in ({"q", "scale"}, {"qrows"}):
                raise ValueError(f"unknown table layout {sorted(tables)} (the port takes a "
                                 "tensor, {'q', 'scale'} or {'qrows'})")
            rows = tables["qrows"] if "qrows" in tables else tables["q"]
        else:
            rows = tables
        hid = torch.as_tensor(np.asarray(hot_ids, dtype=np.int64)).to(rows.device)
        return {**params, "hot_table": rows.index_select(0, hid)}

    def prepare(batch: Batch, out: "dict | None" = None) -> dict:
        """The host split of ``batch`` (a ragged batch's mask is consumed
        here, so the device call is mask-free), padded to the cold ladder.
        ``out``: flat buffers to write it into (``split_hot_cold``'s)."""
        idx = _np(batch.indices)
        smask = None if batch.mask is None else _np(batch.mask)
        B, T, L = idx.shape
        buckets = cold_buckets_for(B * T * L, mesh)
        if mesh is not None and n_data > 1:
            return split_hot_cold_hybrid(idx, offsets_np, hot_ids, n_data, n_shards,
                                         rows_per_shard, cold_buckets=buckets, slot_mask=smask,
                                         hot_index=hot_index)
        if mesh is not None:
            return split_hot_cold_sharded(idx, offsets_np, hot_ids, n_shards, rows_per_shard,
                                          cold_buckets=buckets, slot_mask=smask,
                                          hot_index=hot_index)
        return split_hot_cold(idx, offsets_np, hot_ids, cold_buckets=buckets,
                              slot_mask=smask, hot_index=hot_index, out=out)

    def apply(params: dict, batch: Batch, split: dict) -> torch.Tensor:
        """K6 on the split (tensors on the tables' device), then the model's
        own tail."""
        from deeprecsys_tpu_torch.ops import (
            embedding_bag_hotcold, embedding_bag_hotcold_int8, embedding_bag_hotcold_int8_rowwise)

        cdt = compute_dtype_of(cfg)
        if mesh is not None:
            return _mesh_apply(params, batch, split, cdt)
        tables, hot = params["tables"], params["hot_table"]
        if isinstance(tables, dict) and "qrows" in tables:
            pooled = embedding_bag_hotcold_int8_rowwise(hot, tables["qrows"], split,
                                                        compute_dtype=cdt)
        elif isinstance(tables, dict):
            pooled = embedding_bag_hotcold_int8(hot, tables["q"], tables["scale"], split,
                                                compute_dtype=cdt)
        else:
            pooled = embedding_bag_hotcold(hot, tables, split, compute_dtype=cdt)
        return model.apply_from_pooled(
            {k: v for k, v in params.items() if k != "hot_table"}, pooled, batch)

    def _mesh_apply(sp, batch: Batch, split: dict, cdt) -> torch.Tensor:
        """The mesh lookup (tensor-parallel or hybrid) on ``sp``, a
        ``ShardedParams`` of the converted params, then the model's tail a
        data slice on entry (d, 0); the scores on ``mesh.devices.flat[0]``."""
        from deeprecsys_tpu_torch.parallel.sharding import (
            Sharded, _to, hybrid_hotcold_rows, sharded_embedding_bag_hotcold)

        tables0 = sp.entry(0, 0)["tables"]
        key = ("qrows" if isinstance(tables0, dict) and "qrows" in tables0
               else "q" if isinstance(tables0, dict) else None)
        rows = Sharded(mesh, [[sp.entry(d, m)["tables"] if key is None
                               else sp.entry(d, m)["tables"][key]
                               for m in range(n_shards)] for d in range(n_data)])
        kw = {"compute_dtype": cdt, "rowwise": key == "qrows",
              "table_scale": tables0["scale"] if key == "q" else None}

        def hot(d, m):
            return sp.entry(d, m)["hot_table"]

        if n_data == 1:
            pooled = [sharded_embedding_bag_hotcold(hot, rows, split, mesh, **kw)]
        else:
            pooled = hybrid_hotcold_rows(hot, rows, split, mesh, **kw)
        b = pooled[0].shape[0]
        scores = []
        for d, pooled_d in enumerate(pooled):
            dev = mesh.device(d, 0)
            dense = None if batch.dense is None else _to(batch.dense[d * b:(d + 1) * b], dev)
            scores.append(model.apply_from_pooled(sp.entry(d, 0), pooled_d,
                                                  Batch(dense=dense, indices=None)))
        return torch.cat([_to(s, mesh.devices.flat[0]) for s in scores], dim=0)

    return HotColdModel(base=model, hot_ids=hot_ids, convert_params=convert_params,
                        apply=apply, prepare=prepare)


def with_hot_ids(hc: HotColdModel, hot_ids: np.ndarray, mesh=None,
                 hot_index=None) -> HotColdModel:
    """The same model serving a new hot set, keeping the original ``apply``
    (JAX :261): ``apply`` reads the hot table from the params and never the
    id list, so an engine swaps hot sets at run time."""
    fresh = make_hotcold_model(hc.base, np.asarray(hot_ids), mesh=mesh, hot_index=hot_index)
    return fresh._replace(apply=hc.apply)


def hot_ids_and_coverage_from_generator(
        cfg, seed: int, hot_rows: int, n_batches: int = 8, batch_size: int = 256,
        data_generation: str = "random", trace_file: str | None = None,
        raw_data_file: str | None = None) -> tuple[np.ndarray, float]:
    """The hot set, chosen from the model's own data stream, and its
    coverage, estimated out of sample: selected on the first half of the
    sampled batches, scored on the second (JAX :276). The returned ids are
    selected from the whole sample. Pass the engine's ``data_generation``,
    ``trace_file`` and ``raw_data_file``, so the sample has the locality
    of the stream the engine will serve."""
    from deeprecsys_tpu_torch.data import RecDataGenerator

    gen = RecDataGenerator(cfg, seed=seed, data_generation=data_generation,
                           trace_file=trace_file, raw_data_file=raw_data_file)
    samples = [np.asarray(gen.generate_batch(batch_size).indices) for _ in range(n_batches)]
    sample = np.concatenate(samples, axis=0)
    offsets = np.asarray(cfg.table_offsets)
    hot_ids = select_hot_ids(sample, offsets, hot_rows)
    half = max(1, len(samples) // 2)
    select_half = np.concatenate(samples[:half], axis=0)
    holdout = np.concatenate(samples[half:], axis=0) if len(samples) > half \
        else np.empty((0,) + sample.shape[1:], dtype=sample.dtype)
    holdout_flat = (holdout.astype(np.int64)
                    + offsets.astype(np.int64)[None, :, None]).reshape(-1)
    if holdout_flat.size:
        half_hot = select_hot_ids(select_half, offsets, hot_rows)
        coverage = float(np.isin(holdout_flat, half_hot).mean())
    else:
        coverage = 0.0
    return hot_ids, coverage


def hot_ids_from_generator(cfg, seed: int, hot_rows: int, n_batches: int = 8,
                           batch_size: int = 256, data_generation: str = "random",
                           trace_file: str | None = None,
                           raw_data_file: str | None = None) -> np.ndarray:
    """``hot_ids_and_coverage_from_generator`` without the coverage."""
    return hot_ids_and_coverage_from_generator(
        cfg, seed, hot_rows, n_batches=n_batches, batch_size=batch_size,
        data_generation=data_generation, trace_file=trace_file,
        raw_data_file=raw_data_file)[0]
