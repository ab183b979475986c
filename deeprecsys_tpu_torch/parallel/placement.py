"""Table placement for table-wise sharding (counterpart of
``deeprecsys_tpu/parallel/placement.py``, a copy: that module is pure numpy,
and the port imports nothing of the JAX package;
``tests/test_torch_placement.py`` holds the two equal for every zoo
config at 1, 2, 4 and 8 shards).

Assigns whole tables to mesh "model" shards balancing both memory (rows)
and lookup load (B*L gathers a table): greedy LPT on a weighted cost, with
the row balance as the secondary criterion. Returns a ``TablePlacement``
that the table-wise lookup takes: a permutation of the tables grouped by
shard, each table's row offset within its shard, and the padding that
gives every shard the same number of rows and table slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprecsys_tpu_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    num_shards: int
    # number of REAL tables (slots beyond this are virtual zero-row pads)
    num_real_tables: int
    # table id (incl. virtual) -> shard
    shard_of_table: tuple[int, ...]
    # tables grouped per shard, in original-id order within each shard
    tables_per_shard: tuple[tuple[int, ...], ...]
    # permutation: concatenated tables_per_shard (new order -> old id)
    perm: tuple[int, ...]
    # inverse permutation (old id incl. virtual -> position in new order)
    inv_perm: tuple[int, ...]
    # per-shard padded row count (same for all shards)
    rows_per_shard: int
    # per-table row offsets WITHIN the owning shard's padded region,
    # in permuted order
    local_offsets: tuple[int, ...]
    # lookup-load imbalance: max shard load / mean shard load
    load_imbalance: float

    @property
    def tables_per_shard_count(self) -> int:
        return len(self.perm) // self.num_shards


def plan_tablewise_placement(cfg: ModelConfig, num_shards: int) -> TablePlacement:
    """Greedy balanced placement. Every shard owns the same number of table
    slots (each shard pools a ``(B, cap, L)`` block); where T does not
    divide over the shards, virtual zero-row tables pad the slots, and
    their lookups are dropped on output."""
    T = cfg.num_tables
    cap = -(-T // num_shards)  # ceil
    slots = cap * num_shards
    n_virtual = slots - T
    rows = np.concatenate([np.asarray(cfg.scaled_rows, dtype=np.int64),
                           np.zeros(n_virtual, dtype=np.int64)])
    # Lookup load per table: L gathers a sample (uniform across tables in
    # the fused layout); virtual slots carry none.
    load = np.concatenate([
        np.full(T, cfg.num_indices_per_lookup, dtype=np.float64),
        np.zeros(n_virtual),
    ])
    T = slots
    # Weighted cost: both dimensions normalized and summed.
    cost = load / load.sum() + rows / rows.sum()

    order = np.argsort(-cost)  # heaviest first (LPT)
    shard_cost = np.zeros(num_shards)
    shard_rows = np.zeros(num_shards, dtype=np.int64)
    shard_count = np.zeros(num_shards, dtype=np.int64)
    shard_of = np.empty(T, dtype=np.int64)
    for t in order:
        open_shards = np.flatnonzero(shard_count < cap)
        # Primary: weighted cost; secondary: row balance (memory a shard).
        best = np.lexsort((shard_rows[open_shards], shard_cost[open_shards]))[0]
        s = open_shards[best]
        shard_of[t] = s
        shard_cost[s] += cost[t]
        shard_rows[s] += rows[t]
        shard_count[s] += 1

    tables_per_shard = tuple(
        tuple(int(t) for t in np.flatnonzero(shard_of == s)) for s in range(num_shards)
    )
    perm = tuple(t for group in tables_per_shard for t in group)
    inv = np.empty(T, dtype=np.int64)
    for pos, t in enumerate(perm):
        inv[t] = pos

    # Every shard needs at least one row (virtual lookups read row 0).
    rows_per_shard = max(1, int(max(int(rows[list(g)].sum()) for g in tables_per_shard)))
    local_offsets = []
    for group in tables_per_shard:
        off = 0
        for t in group:
            local_offsets.append(off)
            off += int(rows[t])

    shard_load = np.array([load[list(g)].sum() for g in tables_per_shard])
    imb = float(shard_load.max() / shard_load.mean()) if shard_load.mean() > 0 else 1.0
    return TablePlacement(
        num_shards=num_shards,
        num_real_tables=cfg.num_tables,
        shard_of_table=tuple(int(x) for x in shard_of),
        tables_per_shard=tables_per_shard,
        perm=perm,
        inv_perm=tuple(int(x) for x in inv),
        rows_per_shard=rows_per_shard,
        local_offsets=tuple(local_offsets),
        load_imbalance=imb,
    )
