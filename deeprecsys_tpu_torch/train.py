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

JAX's jitted steps donate the params and the optimizer state; the port
updates them in place instead (``Trainer.params`` and ``opt_state`` are
the same tensors after a step). Not ported: the sharded trainers
(``mesh=``, ROADMAP.md Queue 1 item 12) and ``dedup=True`` (ROADMAP.md
Queue 2 item 5: its argsort + segment-sum was a loss on the TPU, and its
H100 choice waits on a measurement); both raise.

    python -m deeprecsys_tpu_torch.train --model rm1 --steps 200 \\
        [--sparse_tables] [--criteo train.txt] [--save ckpt] \\
        [--export_quant int8_rowwise --export_out ckpt_q] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import numpy as np
import torch

from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import Batch, compute_dtype_of, table_offsets
from deeprecsys_tpu_torch.ops import embedding_bag, sparse_adagrad_step
from deeprecsys_tpu_torch.ops.embedding import quantize_pertable_int8, quantize_rowwise_int8
from deeprecsys_tpu_torch.ops.optimizer import OPTIMIZERS, optimizer_update
from deeprecsys_tpu_torch.parallel.sharding import loss_fn_for
from deeprecsys_tpu_torch.utils.devices import resolve_device
from deeprecsys_tpu_torch.utils.metrics_ml import auc


def _leaves(tree) -> list:
    return list(bridge.flatten(tree).values())


class Optimizer:
    """One of optax's sgd, adagrad and adam (optax 0.2.6 defaults), applied
    in place by ``ops.optimizer.optimizer_update``: kernel K10 on the card,
    optax's update written out op by op on the CPU (the formulas are in
    ``ops/optimizer.py``). The state mirrors the params in their dtype, as
    optax's does: adagrad a list of accumulators (starting at 0.1), adam
    ``{"count", "mu", "nu"}``.
    """

    def __init__(self, name: str, learning_rate: float):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.lr = name, learning_rate

    def init(self, leaves: list):
        if self.name == "adagrad":
            return [torch.full_like(p, 0.1) for p in leaves]
        if self.name == "adam":
            return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                    "nu": [torch.zeros_like(p) for p in leaves]}
        return None

    @torch.no_grad()
    def update(self, leaves: list, grads, state):
        if self.name == "sgd":
            optimizer_update("sgd", leaves, grads, [], self.lr)
        elif self.name == "adagrad":
            optimizer_update("adagrad", leaves, grads, [state], self.lr)
        else:
            state["count"] += 1
            optimizer_update("adam", leaves, grads, [state["mu"], state["nu"]], self.lr,
                             count=state["count"])
        return state


def make_optimizer(name: str, learning_rate: float) -> Optimizer:
    return Optimizer(name, learning_rate)


@dataclasses.dataclass
class TrainHistory:
    losses: list
    eval_aucs: list


def _with_grad(leaves: list, fn):
    """``fn()`` with ``leaves`` requiring grad for its duration only, so the
    trainer's params are plain tensors between steps (serving them runs no
    autograd)."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        return fn()
    finally:
        for p in leaves:
            p.requires_grad_(False)


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

        loss, g = _with_grad(leaves, grads)
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
    """
    if dedup:
        raise NotImplementedError(
            "dedup=True is not ported: its argsort + segment-sum measured a loss on the TPU, "
            "and its H100 choice waits on a measurement (ROADMAP.md Queue 2 item 5)")
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

        loss, g = _with_grad(leaves + [pooled], grads)
        tx_rest.update(leaves, g[:-1], tx_state)
        sparse_adagrad_step(table, table_acc, off, batch.indices, g[-1],
                            table_learning_rate, eps)
        return loss.detach()

    return step


class Trainer:
    """The single-device trainer (JAX ``train.py:285-471``).

    ``params``: the port's tensors to start from instead of the seed's init
    (e.g. ``bridge.params_from_numpy`` of the JAX package's params); they
    are copied to ``device``, and the optimizer state is built from the
    copy. ``device`` is the card by default (raises without one); the tests
    pass ``"cpu"``, where every kernel wrapper runs its plain version.
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
        device: str | torch.device = "cuda",
        params: dict | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError("the sharded trainers (mesh=) are not ported yet "
                                      "(ROADMAP.md Queue 1 item 12, multi-device)")
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
        self.device = resolve_device(str(device))
        self.sparse_tables = sparse_tables
        self.model = get_model(cfg, self.device)
        self.loss_fn = loss_fn_for(loss, sigmoid_output(cfg))
        self.tx = make_optimizer(optimizer, learning_rate)
        if params is None:
            params = self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        else:
            params = bridge.tree_map(lambda t: t.detach().to(self.device, copy=True), params)
        self.params = params
        if sparse_tables:
            rest = {k: v for k, v in params.items() if k != "tables"}
            table_acc = torch.zeros((params["tables"].shape[0],), dtype=torch.float32,
                                    device=self.device)
            self.opt_state = (self.tx.init(_leaves(rest)), table_acc)
            self._step = make_sparse_table_step(
                self.model, cfg, self.tx, learning_rate, self.loss_fn,
                table_learning_rate=table_learning_rate, dedup=dedup)
        else:
            if dedup:
                raise NotImplementedError("dedup=True applies to sparse_tables only, and is not "
                                          "ported (ROADMAP.md Queue 2 item 5)")
            self.opt_state = self.tx.init(_leaves(params))
            self._step = make_dense_step(self.model, self.tx, self.loss_fn)

    def _targets(self, labels: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(labels, dtype=np.float32))
        if t.ndim == 1:
            t = t[:, None].expand(t.shape[0], self.cfg.out_dim)
        return t.contiguous().to(self.device)

    def step(self, host: Batch, labels) -> torch.Tensor:
        """One train step on a host batch and its (B,) or (B, out_dim)
        labels; returns the loss (a device scalar, not synchronised)."""
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
        with torch.inference_mode():
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
    1), which is what a checkpoint stores."""
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
        save_params(args.save, bridge.params_to_numpy(tr.params, tr.cfg))
        print(f"saved params -> {args.save}", flush=True)
    if args.export_quant:
        out = args.export_out or (args.save or "serving_params") + f"_{args.export_quant}"
        sp, scfg = export_serving_params(tr.params, tr.cfg, table_quant=args.export_quant)
        save_params(out, bridge.params_to_numpy(sp, scfg))
        print(f"exported {args.export_quant} serving bundle -> {out}", flush=True)
    return losses


if __name__ == "__main__":
    main()
