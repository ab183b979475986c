"""Training API (counterpart of ``deeprecsys_tpu/train.py``).

The single-device trainer of the JAX package on the card:

- the optimizers of ``make_optimizer`` (sgd, adagrad, adam) with optax's
  update formulas (``Optimizer``), not ``torch.optim``'s: optax's adagrad
  starts its accumulator at 0.1 and scales by rsqrt(acc + 1e-7), torch's
  starts at 0 and divides by sqrt(acc) + eps. Every param takes the
  update in one fused pass, kernel K10 (``ops/optimizer.py``);
- the losses of ``parallel/sharding.py`` and ROC AUC evaluation;
- two table-update modes: the default dense autodiff path, where the
  lookup's backward is kernel K1b (``ops/embedding.py``) and the whole
  ``(R, d)`` table takes the optimizer's dense sweep, and
  ``sparse_tables=True``, where the dense half trains under the optimizer
  and the table takes row-wise AdaGrad on the touched rows only, kernel K5
  (``ops/sparse_adagrad.py``);
- DIEN's scans differentiate through kernel K3b (``ops/rnn.py``);
- checkpoints in the JAX package's file format (``utils/checkpoint.py``)
  and the int8 serving export (``export_serving_params``).

Over a mesh (``Trainer(mesh=)``, ``parallel/``): the dense mode's step
differentiates through the row-sharded lookup (K1's and K1b's ownership
windows, ``parallel/sharding.py::make_mesh_dense_step``) and K10 updates
the distinct tensors of each device; the sparse mode is
``make_sharded_sparse_table_step`` (K1's window, then K5's window on each
row shard). A mesh may span processes (``parallel.distributed_init``):
every process runs the same steps on the same batches, and the combines
are collectives over ``torch.distributed``. ``dedup=True``
(``dedup_touched_rows``: a sort and a segment
sum in torch ops, then K5 over the unique rows) merges a row's repeated
gradients before the update, on one device and on a mesh; it stays off by
default (ROADMAP.md Queue 2 item 5 holds its measurement on the card).

JAX's jitted steps donate the params and the optimizer state; the port
updates them in place instead (``Trainer.params`` and ``opt_state`` are
the same tensors after a step). JAX compiles each step once a batch shape;
the port's ``Trainer`` runs its steps through ``train_programs.py``'s
``StepPrograms``: on a card the first step of a shape runs eagerly, is then
captured as a CUDA graph, and every later step of the shape is a replay,
on the trainer's own stream. A mesh across processes or cards, and K5's
bf16 window, stay eager (``Trainer.eager_reason``, decided when the trainer
is built).

    python -m deeprecsys_tpu_torch.train --model rm1 --steps 200 \\
        [--sparse_tables] [--criteo train.txt] [--save ckpt] \\
        [--export_quant int8_rowwise --export_out ckpt_q] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import weakref
from typing import Callable

import numpy as np
import torch

from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import Batch, compute_dtype_of, table_offsets
from deeprecsys_tpu_torch.ops import embedding_bag, sparse_adagrad_step, sparse_adagrad_step_shard
from deeprecsys_tpu_torch.ops.embedding import quantize_pertable_int8, quantize_rowwise_int8
from deeprecsys_tpu_torch.ops.optimizer import Optimizer
from deeprecsys_tpu_torch.parallel.sharding import (
    MeshOptimizer, Replicated, Sharded, ShardedParams, all_gather_slices, leaf_copies,
    leaf_groups, loss_fn_for, make_mesh_dense_step, mesh_loss, pooled_on_row, reduce_copies,
    shard_params, sharded_apply, split_batch, split_targets, unshard_params, with_grad)
from deeprecsys_tpu_torch.train_programs import StepPrograms, eager_reason
from deeprecsys_tpu_torch.utils.devices import resolve_device
from deeprecsys_tpu_torch.utils.metrics_ml import auc


def _leaves(tree) -> list:
    return list(bridge.flatten(tree).values())


def make_optimizer(name: str, learning_rate: float) -> Optimizer:
    return Optimizer(name, learning_rate)


@dataclasses.dataclass
class TrainHistory:
    losses: list
    eval_aucs: list


def dedup_touched_rows(flat: torch.Tensor, g_rows: torch.Tensor):
    """Merge duplicate touched-row gradients before the update (JAX
    ``train.py:66-94``): a stable sort of the ``(N,)`` fused row ids, a run
    mask, its ``cumsum`` as segment ids, and a segment sum of the f32
    gradient rows into an ``(N, d)`` buffer, so that each unique row takes
    its true gradient (the sum over its occurrences) once.

    Returns ``(uids (N,), summed (N, d) f32)``: one entry a unique row in
    ascending order, then an inert tail (uid 0, gradient 0: zero-adds on
    row 0). The unique ids are a scatter of the sorted ids at their segment
    ids, where every member of a run writes the same value: no shape
    depends on the data, so nothing is read back from the card and the
    step can be captured as a CUDA graph. On the card the segment sum's
    adds are atomic, in no fixed order."""
    N, d = g_rows.shape
    sid, order = torch.sort(flat, stable=True)
    newrun = torch.ones((N,), dtype=torch.bool, device=flat.device)
    newrun[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(newrun, 0) - 1
    summed = torch.zeros((N, d), dtype=torch.float32, device=g_rows.device)
    summed.index_add_(0, seg, g_rows.float().index_select(0, order))
    uids = torch.zeros_like(flat).scatter_(0, seg, sid)
    return uids, summed


def _dedup_stream(offsets, indices, g) -> tuple:
    """K5's ``(offsets, ids, g)`` over the unique rows of a stream:
    ``dedup_touched_rows`` of its fused ids and broadcast gradients, each
    unique row a bag of one fused row (``offsets = [0]``, ids ``(N, 1,
    1)``, ``g (N, 1, d)``). So dedup adds no kernel."""
    B, T, L = indices.shape
    d = g.shape[-1]
    flat = (indices + offsets[None, :, None]).reshape(-1)
    rows = g.float()[:, :, None, :].expand(B, T, L, d).reshape(B * T * L, d)
    uids, summed = dedup_touched_rows(flat, rows)
    return (torch.zeros((1,), dtype=torch.int32, device=indices.device),
            uids.reshape(-1, 1, 1).to(torch.int32), summed.reshape(-1, 1, d))


def make_dense_step(model, tx: Optimizer, loss_fn):
    """Train step by autodiff through the whole model: the lookup's table
    gradient is K1b's dense ``(R, d)`` scatter, and every param, the table
    included, takes the optimizer's dense sweep (JAX ``Trainer._build_step``,
    ``train.py:354-367``). ``step(params, opt_state, batch, targets)``
    updates ``params`` and ``opt_state`` in place and returns the loss."""
    def step(params, opt_state, batch: Batch, targets):
        leaves = _leaves(params)

        def grads():
            loss = loss_fn(model.apply(params, batch), targets)
            return loss, torch.autograd.grad(loss, leaves)

        loss, g = with_grad(leaves, grads)
        tx.update(leaves, g, opt_state)
        return loss.detach()

    return step


def make_sparse_table_step(model, cfg: ModelConfig, tx_rest: Optimizer, learning_rate: float,
                           loss_fn, eps: float = 1e-8,
                           table_learning_rate: float | None = None, dedup: bool = False):
    """Train step with sparse table updates (JAX ``train.py:210-282``): the
    forward is split at the pooled embeddings; the dense half trains under
    ``tx_rest`` as usual, and the table takes row-wise AdaGrad on the rows
    the batch looked up, each row receiving its bag's pooled-output
    gradient (K5). ``opt_state`` is ``(tx_state, table_acc)``. The table
    always takes row-wise AdaGrad (the JAX step's ``rowwise_adagrad=True``,
    the only mode its Trainer uses). Step cost is O(B*T*L) rows whatever R.
    ``dedup``: each row's occurrences merged first (``dedup_touched_rows``),
    so the accumulator sees the row's true gradient once (JAX ``:264-265``).
    """
    if table_learning_rate is None:
        table_learning_rate = learning_rate
    cdt = compute_dtype_of(cfg)
    offsets: dict = {}

    def step(params, opt_state, batch: Batch, targets):
        table = params["tables"]
        rest = {k: v for k, v in params.items() if k != "tables"}
        tx_state, table_acc = opt_state
        off = offsets.get(table.device)
        if off is None:
            off = offsets[table.device] = table_offsets(cfg, table.device)
        with torch.no_grad():
            pooled = embedding_bag(table, off, batch.indices, compute_dtype=cdt)
        leaves = _leaves(rest)

        def grads():
            # apply_from_pooled never reads params["tables"]: the lookup is
            # what `pooled` replaces.
            loss = loss_fn(model.apply_from_pooled(rest, pooled, batch), targets)
            return loss, torch.autograd.grad(loss, leaves + [pooled])

        loss, g = with_grad(leaves + [pooled], grads)
        tx_rest.update(leaves, g[:-1], tx_state)
        stream = (_dedup_stream(off, batch.indices, g[-1]) if dedup
                  else (off, batch.indices, g[-1]))
        sparse_adagrad_step(table, table_acc, *stream, table_learning_rate, eps)
        return loss.detach()

    return step


def touched_rows(offsets: torch.Tensor, indices: torch.Tensor, row_lo: int,
                 rows: int) -> torch.Tensor:
    """The local rows of the shard ``[row_lo, row_lo + rows)`` that a
    stream's ids touch (repeats kept)."""
    local = (indices.long() + offsets.long()[None, :, None]).reshape(-1) - row_lo
    return local[(local >= 0) & (local < rows)]


def update_shard_copies(tables: list, accs: list, offsets: torch.Tensor, indices: torch.Tensor,
                        g: torch.Tensor, row_lo: int, learning_rate: float, eps: float = 1e-8):
    """One row shard's sparse step over all of its copies: K5's window
    (``sparse_adagrad_step_shard``) on ``tables[0]`` and ``accs[0]`` once,
    then the rows the stream touched in the shard copied from that first
    copy into every other (an ``index_select`` on the owner, an
    ``index_copy_`` on each other copy, across cards where the copies lie
    on several). So every copy equals the first bit for bit, as JAX's
    sharded step keeps one array a shard (``train.py:177-182``), where a
    launch a copy would round K5's atomic adds in another order on each.
    ``offsets``, ``indices`` and ``g`` are the stream on the first copy's
    device."""
    table, acc = tables[0], accs[0]
    sparse_adagrad_step_shard(table, acc, offsets, indices, g, row_lo, learning_rate, eps)
    if len(tables) == 1:
        return
    rows = touched_rows(offsets, indices, row_lo, table.shape[0])
    _set_rows(tables[1:], accs[1:], rows, table.index_select(0, rows), acc.index_select(0, rows))


def _set_rows(tables: list, accs: list, rows, t_rows, a_rows):
    """``rows`` of each copy of a shard and its accumulator set to
    ``t_rows`` and ``a_rows``."""
    for t, a in zip(tables, accs):
        r = rows.to(t.device)
        t.index_copy_(0, r, t_rows.to(t.device))
        a.index_copy_(0, r, a_rows.to(a.device))


def _send_shard_rows(mesh, m: int, tables: list, accs: list, offsets: torch.Tensor,
                     indices: torch.Tensor, row_lo: int):
    """Shard m's copies on the other processes of column m made equal to
    its first copy (entry (0, m)) after its update: the rows the batch's
    ids touch, of the table and of the accumulator, broadcast from entry
    (0, m)'s process inside column m's group and copied into this process's
    copies. ``tables``/``accs``: this process's distinct copies of shard m;
    ``offsets``/``indices``: the whole batch's (every process has them)."""
    ranks = mesh.col_ranks(m)
    if len(ranks) == 1:
        return
    table, acc, src = tables[0], accs[0], mesh.rank_of(0, m)
    rows = touched_rows(offsets.to(table.device), indices.to(table.device), row_lo,
                        table.shape[0])
    if mesh.rank == src:
        t_rows, a_rows = table.index_select(0, rows), acc.index_select(0, rows)
    else:
        t_rows = torch.empty((len(rows), table.shape[1]), dtype=table.dtype, device=table.device)
        a_rows = torch.empty((len(rows),), dtype=acc.dtype, device=acc.device)
    t_rows, a_rows = mesh.broadcast(t_rows, src, ranks), mesh.broadcast(a_rows, src, ranks)
    if mesh.rank != src:
        _set_rows(tables, accs, rows, t_rows, a_rows)


def make_sharded_sparse_table_step(model, cfg: ModelConfig, tx_rest: Optimizer,
                                   learning_rate: float, loss_fn, mesh, eps: float = 1e-8,
                                   table_learning_rate: float | None = None,
                                   dedup: bool = False):
    """Sparse-table training over a (data, model) mesh (JAX
    ``train.py:97-207``): the table and its row-wise AdaGrad accumulator
    row-sharded over "model", the batch over "data".

    ``step(sp, opt_state, batch, targets)`` updates in place and returns
    the loss; ``opt_state`` is ``(MeshOptimizer of the non-table leaves,
    Sharded accumulator)``. Each data slice looks up with K1's window on
    every shard (no grad), combined on entry (d, 0), and runs
    ``apply_from_pooled`` there; the loss is the mean of the slices' means,
    so the dense half's gradients are their mean over "data" (summed over
    a leaf's copies) and each slice's pooled gradient carries the 1 / D of
    the JAX step's ``g_pooled / n_data``. Then the all-gather over "data":
    for each shard m, one K5 window launch (``sparse_adagrad_step_shard``)
    on its first copy (entry (0, m)) over all D slices' ids and pooled
    gradients, concatenated in data-row order on that copy's device, so
    every accumulator add lands before any scale is read; the touched rows
    are then copied into the shard's other copies (``update_shard_copies``),
    so the copies stay equal bit for bit, as JAX's one array a shard. On
    one card the copies are one tensor. ``dedup``: the concatenated
    stream's rows merged first (``dedup_touched_rows``, once a device),
    then the window over the unique rows.

    Across processes every process takes the same batch: the pooled
    gradients go from each entry (d, 0)'s process to every process
    (``all_gather_slices``), entry (0, m)'s process runs shard m's window,
    and its touched rows go to the copies on the column's other processes
    (``_send_shard_rows``).
    """
    M = mesh.shape["model"]
    if cfg.total_rows % M:
        raise ValueError("pad tables to divide over the model axis")
    rps = cfg.total_rows // M
    if table_learning_rate is None:
        table_learning_rate = learning_rate
    offsets = Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))

    def step(sp: ShardedParams, opt_state, batch: Batch, targets):
        tx_state, acc = opt_state
        slices, tsl = split_batch(batch, mesh), split_targets(targets, mesh)
        with torch.no_grad():  # the single-device step's lookup reads no mask either
            pooled = [pooled_on_row(sp, d, sl._replace(mask=None), cfg, offsets)
                      for d, sl in enumerate(slices)]
        owned = [p for p in pooled if p is not None]
        groups = leaf_groups(sp, skip=("tables",))
        leaves = [t for _, copies in groups for t in copies]

        def grads():
            share, loss = mesh_loss(model, sp, slices, tsl, loss_fn, lambda d, sl: pooled[d])
            if share is None:
                return loss, (None,) * (len(leaves) + len(owned))
            return loss, torch.autograd.grad(share, leaves + owned, allow_unused=True)

        loss, g = with_grad(leaves + owned, grads)
        tx_state.update(leaves, reduce_copies(mesh, groups, list(g[:len(leaves)])))
        g_owned = iter(g[len(leaves):])
        g_pooled = all_gather_slices(mesh, [None if p is None else next(g_owned)
                                            for p in pooled],
                                     (*slices[0].indices.shape[:2], cfg.sparse_feature_size),
                                     compute_dtype_of(cfg))
        all_ids = torch.cat([sl.indices for sl in slices]) if mesh.multi_process else None
        streams: dict = {}
        for m in range(M):
            tables, accs = [], []
            for d in range(mesh.shape["data"]):
                shard = sp.entry(d, m)
                if shard is not None and not any(t is shard["tables"] for t in tables):
                    tables.append(shard["tables"])
                    accs.append(acc.part(d, m))
            if mesh.is_local(0, m):
                dev = tables[0].device
                if dev not in streams:  # every slice's ids and gradients, in data-row order
                    stream = (offsets.on(dev), torch.cat([sl.indices.to(dev) for sl in slices]),
                              torch.cat([gp.to(dev) for gp in g_pooled]))
                    streams[dev] = _dedup_stream(*stream) if dedup else stream
                update_shard_copies(tables, accs, *streams[dev], m * rps, table_learning_rate,
                                    eps)
            if all_ids is not None and tables:
                _send_shard_rows(mesh, m, tables, accs, offsets.on(tables[0].device), all_ids,
                                 m * rps)
        return loss.detach()

    return step


class Trainer:
    """The trainer (JAX ``train.py:285-471``), on one device or a mesh.

    ``params``: the port's tensors to start from instead of the seed's init
    (e.g. ``bridge.params_from_numpy`` of the JAX package's params); they
    are copied to ``device``, and the optimizer state is built from the
    copy. ``device`` is the card by default (raises without one); the tests
    pass ``"cpu"``, where every kernel wrapper runs its plain version.

    With ``mesh`` (``parallel.make_mesh``) the params are ``shard_params``
    of the init (made on the mesh's first device) or of ``params``, a
    ``ShardedParams``; ``device`` is the mesh's first device (``mesh.home``:
    this process's, on a mesh across processes, where every process builds
    the trainer from the same params and steps on the same batches). Dense mode
    trains by ``make_mesh_dense_step`` (the optimizer state a distinct
    tensor, so the table's is row-sharded with it), sparse mode by
    ``make_sharded_sparse_table_step`` with a row-sharded accumulator.
    ``evaluate`` runs ``sharded_apply``; ``full_params()`` is
    ``unshard_params``' full tensors, what checkpoints and
    ``export_serving_params`` write (across processes every process calls
    it; rank 0 writes).

    Steps go through ``step_program`` (``train_programs.StepPrograms``: a
    CUDA graph a batch shape on a card, replayed on the trainer's stream,
    where evaluation runs too; the eager step over static buffers on the
    CPU), or, where ``eager_reason`` says why, straight to the step function
    on the caller's streams (``step_program`` None). Assigning ``params`` or
    ``opt_state`` drops the captured programs.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        mesh=None,
        optimizer: str = "adagrad",
        learning_rate: float = 0.01,
        loss: str = "bce",
        seed: int = 0,
        sparse_tables: bool = False,
        table_learning_rate: float | None = None,
        dedup: bool = False,
        *,
        device: str | torch.device | None = None,
        params: dict | None = None,
    ):
        if cfg.table_quant != "none":
            raise ValueError("training requires float tables (table_quant='none')")
        if sparse_tables and cfg.resolved_table_pack > 1:
            # The touched-rows update works on the logical (R, d) layout;
            # export_serving_params and the serving config re-pack.
            cfg = cfg.replace(table_pack=1)
        if not sigmoid_output(cfg) and cfg.output_head != "logits":
            # Training through the relu head is gradient-dead (the JAX
            # trainer's note, train.py:307-315); the head has no params, so
            # the checkpoint serves either head.
            cfg = cfg.replace(output_head="logits")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(str(device or "cuda"))
        else:
            self.device = mesh.home
            want = resolve_device(str(device)) if device is not None else self.device
            if want.type != self.device.type or want.index not in (None, self.device.index):
                raise ValueError(f"device {device} is not the mesh's first device {self.device} "
                                 "(this process's)")
        self.sparse_tables = sparse_tables
        self.model = get_model(cfg, self.device)
        self.loss_fn = loss_fn_for(loss, sigmoid_output(cfg))
        self.tx = make_optimizer(optimizer, learning_rate)
        if params is None:
            params = self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        else:
            params = bridge.tree_map(lambda t: t.detach().to(self.device, copy=True), params)
        self.step_program = None
        if mesh is not None:
            self._init_mesh(params, learning_rate, table_learning_rate, dedup)
        else:
            self._init_one_device(params, learning_rate, table_learning_rate, dedup)
        table = self.params.first_entry()["tables"] if mesh is not None else self.params["tables"]
        self.eager_reason = eager_reason(mesh, table.dtype, sparse_tables)
        if self.eager_reason is None:
            # A weak reference: the programs must not keep the trainer (its
            # tables, state and graph pool) alive in a cycle after its last
            # reference goes.
            trainer = weakref.ref(self)

            def step(batch: Batch, targets: torch.Tensor) -> torch.Tensor:
                tr = trainer()
                return tr._step(tr.params, tr.opt_state, batch, targets)

            self.step_program = StepPrograms(step, self.device)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._params = value
        self._drop_programs()

    @property
    def opt_state(self):
        return self._opt_state

    @opt_state.setter
    def opt_state(self, value):
        self._opt_state = value
        self._drop_programs()

    def _drop_programs(self):
        """The captured programs read the tensors they were captured with:
        new params or state drop them."""
        if getattr(self, "step_program", None) is not None:
            self.step_program.reset()

    def _init_one_device(self, params: dict, learning_rate: float, table_learning_rate,
                         dedup: bool):
        cfg = self.cfg
        self.params = params
        if self.sparse_tables:
            rest = {k: v for k, v in params.items() if k != "tables"}
            table_acc = torch.zeros((params["tables"].shape[0],), dtype=torch.float32,
                                    device=self.device)
            self.opt_state = (self.tx.init(_leaves(rest)), table_acc)
            self._step = make_sparse_table_step(
                self.model, cfg, self.tx, learning_rate, self.loss_fn,
                table_learning_rate=table_learning_rate, dedup=dedup)
        else:
            self.opt_state = self.tx.init(_leaves(params))
            self._step = make_dense_step(self.model, self.tx, self.loss_fn)

    def _init_mesh(self, params: dict, learning_rate: float, table_learning_rate, dedup: bool):
        mesh, cfg = self.mesh, self.cfg
        self.params = sp = shard_params(params, mesh)
        self._apply = sharded_apply(self.model, mesh, has_dense=cfg.dense_dim > 0)
        if self.sparse_tables:
            self._step = make_sharded_sparse_table_step(
                self.model, cfg, self.tx, learning_rate, self.loss_fn, mesh,
                table_learning_rate=table_learning_rate, dedup=dedup)
            rest = leaf_copies(sp, skip=("tables",))
            acc = Sharded.place(mesh, lambda m: torch.zeros(
                (sp.rows_per_shard,), dtype=torch.float32, device=self.device))
            self.opt_state = (MeshOptimizer(self.tx, [t for c in rest for t in c]), acc)
        else:
            self.opt_state = MeshOptimizer(self.tx, [t for c in leaf_copies(sp) for t in c])
            self._step = make_mesh_dense_step(self.model, mesh, self.loss_fn)

    def full_params(self) -> dict:
        """The params as one tensor a leaf: ``self.params`` on one device,
        ``unshard_params`` (host copies) on a mesh."""
        return self.params if self.mesh is None else unshard_params(self.params)

    def _targets(self, labels: np.ndarray, on_host: bool = False) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(labels, dtype=np.float32))
        if t.ndim == 1:
            t = t[:, None].expand(t.shape[0], self.cfg.out_dim)
        return t.contiguous() if on_host else t.contiguous().to(self.device)

    def step(self, host: Batch, labels) -> torch.Tensor:
        """One train step on a host batch and its (B,) or (B, out_dim)
        labels; returns the loss (a device scalar, not synchronised): the
        batch shape's program (``step_program``), or the eager step where
        ``eager_reason`` keeps it so."""
        if self.step_program is not None:
            return self.step_program(host, self._targets(labels, on_host=True))
        return self._step(self.params, self.opt_state, host.to(self.device),
                          self._targets(labels))

    def fit(self, num_steps: int, batch_size: int = 128, seed: int = 1,
            eval_every: int = 0, label_fn: Callable | None = None) -> TrainHistory:
        """Train on synthetic data (the port's generator gives the JAX
        package's batches for a seed). ``label_fn(batch) -> (B,)`` labels;
        defaults to a dense-feature threshold rule for dense models, an
        index-parity rule otherwise. The loss is read every step, which
        synchronises the host with the card, as JAX's ``float(loss)`` does."""
        gen = RecDataGenerator(self.cfg, seed=seed)
        losses, aucs = [], []
        for i in range(num_steps):
            host = gen.generate_batch(batch_size)
            losses.append(float(self.step(host, self._labels(host, label_fn))))
            if eval_every and (i + 1) % eval_every == 0:
                aucs.append(self.evaluate(gen, batch_size, label_fn))
        return TrainHistory(losses=losses, eval_aucs=aucs)

    def _labels(self, host: Batch, label_fn) -> np.ndarray:
        if label_fn is not None:
            return np.asarray(label_fn(host), dtype=np.float32)
        if host.dense is not None:
            m = host.dense.mean(axis=1)
            return (m > np.median(m)).astype(np.float32)
        return (host.indices[:, 0, 0] % 2).astype(np.float32)

    def _scores(self, host: Batch) -> np.ndarray:
        """The forward's scores on the host: eager (JAX jits it; the port
        captures only the steps), on the trainer's stream."""
        on_stream = (self.step_program.on_stream() if self.step_program is not None
                     else contextlib.nullcontext())
        with on_stream, torch.inference_mode():
            if self.mesh is not None:
                out = self._apply(self.params, host.to(self.device))
            else:
                out = self.model.apply(self.params, host.to(self.device))
            return out.float().cpu().numpy()

    def evaluate(self, gen: RecDataGenerator, batch_size: int = 256,
                 label_fn: Callable | None = None) -> float:
        host = gen.generate_batch(batch_size)
        labels = self._labels(host, label_fn)
        return auc(self._scores(host)[:, 0], labels.astype(int))

    def evaluate_batches(self, batches) -> dict:
        """Held-out ROC AUC and binary log-loss over (host Batch, labels)
        pairs (e.g. ``CriteoReader.batches``); raw-logit models are turned
        into probabilities for the log-loss."""
        probs, ys = [], []
        sig = sigmoid_output(self.cfg)
        for host, labels in batches:
            s = self._scores(host)[:, 0]
            if not sig:
                s = 1.0 / (1.0 + np.exp(-s))
            probs.append(s)
            ys.append(np.asarray(labels, np.float32).reshape(-1))
        if not probs:
            raise ValueError("evaluate_batches: empty batch iterable")
        p = np.concatenate(probs)
        y = np.concatenate(ys)
        pc = np.clip(p, 1e-7, 1.0 - 1e-7)
        logloss = float(-np.mean(y * np.log(pc) + (1 - y) * np.log(1 - pc)))
        return {"auc": auc(p, y.astype(int)), "logloss": logloss, "n": int(y.size)}


def export_serving_params(params: dict, cfg: ModelConfig, table_quant: str = "int8_rowwise"):
    """Trained float params as a quantized serving bundle (JAX
    ``train.py:474-516``): ``int8_rowwise`` ``{"qrows": (R, d+4) int8}`` or
    per-table ``int8`` ``{"q": (R, d) int8, "scale": (T,) f32}``. Returns
    ``(serving_params, serving_cfg)``. The port's tensors stay unpacked;
    ``bridge.params_to_numpy(serving_params, serving_cfg)`` gives the JAX
    package's layout (``q_packed`` where ``serving_cfg`` resolves to pack >
    1), which is what a checkpoint stores. A mesh trainer's
    ``ShardedParams`` are read back whole first (``unshard_params``)."""
    if isinstance(params, ShardedParams):
        params = unshard_params(params)
    tables = params["tables"]
    if isinstance(tables, dict):
        raise ValueError("params already quantized")
    if isinstance(tables, np.ndarray):  # a load_model_params leaf
        tables = torch.from_numpy(np.ascontiguousarray(tables))
    tables = tables.detach()
    scfg = cfg.replace(table_quant=table_quant)
    if table_quant == "int8_rowwise":
        new_tables = {"qrows": quantize_rowwise_int8(tables)}
    elif table_quant == "int8":
        new_tables = quantize_pertable_int8(tables, cfg.scaled_rows)
    else:
        raise ValueError(f"unknown table_quant {table_quant!r}")
    return dict(params, tables=new_tables), scfg


def _fit_batches(trainer: Trainer, batches) -> list[float]:
    """The train step over (host Batch, labels) pairs (e.g.
    ``CriteoReader.batches``); returns the per-step losses."""
    return [float(trainer.step(host, labels)) for host, labels in batches]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="DeepRecSys trainer on PyTorch + CUDA")
    ap.add_argument("--model", default="rm1",
                    help=f"zoo name {zoo.MODEL_NAMES} (ignored with --criteo)")
    ap.add_argument("--table_scale", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--optimizer", default="adagrad", choices=["sgd", "adagrad", "adam"])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--loss", default="bce", choices=["bce", "mse"])
    ap.add_argument("--sparse_tables", action="store_true",
                    help="touched-rows-only table updates + row-wise AdaGrad")
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--criteo_eval", default=None,
                    help="held-out Criteo TSV: report ROC-AUC + log-loss "
                         "after each epoch (with --criteo)")
    ap.add_argument("--eval_batches", type=int, default=64,
                    help="held-out batches per evaluation (--criteo_eval)")
    ap.add_argument("--criteo", default=None,
                    help="Criteo/Kaggle TSV file: train on real data instead of synthetic")
    ap.add_argument("--criteo_rows_per_table", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=1, help="epochs over --criteo")
    ap.add_argument("--save", default=None, help="checkpoint path for trained params")
    ap.add_argument("--export_quant", default=None, choices=["int8", "int8_rowwise"],
                    help="also export a quantized serving bundle")
    ap.add_argument("--export_out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compilation_cache_dir", default=None,
                    help="the JAX package's compilation cache; the port compiles no "
                         "programs, so it has no effect here")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when no card is present) or 'cpu'")
    return ap


def main(argv=None):
    """The training CLI; prints the JAX trainer's lines and returns the
    per-step losses."""
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    args = build_parser().parse_args(argv)
    kw = dict(optimizer=args.optimizer, learning_rate=args.lr, loss=args.loss,
              seed=args.seed, sparse_tables=args.sparse_tables, device=args.device)
    if args.criteo:
        from deeprecsys_tpu_torch.data.criteo import CriteoReader, criteo_model_config

        cfg = criteo_model_config(rows_per_table=args.criteo_rows_per_table)
        tr = Trainer(cfg, **kw)
        reader = CriteoReader(args.criteo, cfg)
        losses = []
        for epoch in range(args.epochs):
            ls = _fit_batches(tr, reader.batches(args.batch_size, max_batches=args.steps))
            losses.extend(ls)
            msg = (f"epoch {epoch}: {len(ls)} steps, "
                   f"loss {np.mean(ls[:4]):.4f} -> {np.mean(ls[-4:]):.4f}")
            if args.criteo_eval:
                ev = tr.evaluate_batches(CriteoReader(args.criteo_eval, cfg).batches(
                    args.batch_size, max_batches=args.eval_batches))
                msg += (f", holdout AUC {ev['auc']:.4f} "
                        f"logloss {ev['logloss']:.4f} ({ev['n']} rows)")
            print(msg, flush=True)
    else:
        cfg = zoo.get_config(args.model, table_scale=args.table_scale)
        tr = Trainer(cfg, **kw)
        hist = tr.fit(args.steps, batch_size=args.batch_size, eval_every=args.eval_every)
        losses = hist.losses
        msg = (f"{len(losses)} steps, loss {np.mean(losses[:4]):.4f} -> "
               f"{np.mean(losses[-4:]):.4f}")
        if hist.eval_aucs:
            msg += f", AUC {hist.eval_aucs[-1]:.3f}"
        print(msg, flush=True)

    if args.save:
        save_params(args.save, bridge.params_to_numpy(tr.full_params(), tr.cfg))
        print(f"saved params -> {args.save}", flush=True)
    if args.export_quant:
        out = args.export_out or (args.save or "serving_params") + f"_{args.export_quant}"
        sp, scfg = export_serving_params(tr.full_params(), tr.cfg, table_quant=args.export_quant)
        save_params(out, bridge.params_to_numpy(sp, scfg))
        print(f"exported {args.export_quant} serving bundle -> {out}", flush=True)
    return losses


if __name__ == "__main__":
    main()
