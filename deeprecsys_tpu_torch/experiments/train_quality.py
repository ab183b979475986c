"""Training to quality: the sparse-table trainer learns a planted signal.

Counterpart of ``deeprecsys_tpu/experiments/train_quality.py:39-195``. The
reference is inference-only with random weights, so no dataset is needed to
ask whether training works: labels are planted in the embedding rows.

Each fused row r carries a hidden weight w[r] ~ N(0, 1), and a sample with
lookups {r_1..r_n} (n = T*L) is positive with probability

    p = sigmoid(alpha * sum_i w[r_i] / sqrt(n))

The dense features stay uninformative, so any AUC above 0.5 comes from the
tables, the part the sparse trainer (K5's touched-rows AdaGrad) updates.
The true logit is the Bayes-optimal score, so ``bayes_auc`` of the holdout
is the ceiling a trained model is held against. Ids are zipf(1.2) folded
into each table's rows.

The numpy half (``planted_weights``, ``zipf_batch``, ``planted_logits``,
``planted_labels``, ``make_holdout``, ``bayes_auc``) is the JAX module's,
the same draws in the same order, so both packages train and evaluate on
the same arrays; ``train_planted`` runs the port's ``Trainer`` with
``sparse_tables=True`` at the JAX defaults for ``lr`` and ``table_lr``.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def planted_weights(cfg, seed: int = 5) -> np.ndarray:
    """(total_rows,) float32 hidden per-row signal weights."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(cfg.total_rows, dtype=np.float32)


def zipf_batch(cfg, batch: int, rng) -> np.ndarray:
    """(B, T, L) int32 zipf(1.2) ids folded into each table's rows — the
    skew_bench stream shape, but drawn FRESH per call from ``rng`` (a
    trainer must see new samples every step, not one fixed batch)."""
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    return (rng.zipf(1.2, size=(batch, T, L)) % rows[None, :, None]).astype(
        np.int32)


def planted_logits(cfg, idx: np.ndarray, w: np.ndarray,
                   alpha: float = 3.0, signal_tables=None) -> np.ndarray:
    """(B,) true logits for a (B, T, L) id batch under the planted rule.

    ``signal_tables`` (list of table indices, or None = all): restrict
    the signal to a SUBSET of tables. Used by the dien recency control
    (see ``train_planted``): planting the signal only on the last few
    behavior tables makes it reachable exclusively through the GRU scan,
    which isolates whether that path can learn at all."""
    offsets = np.asarray(cfg.table_offsets, dtype=np.int64)
    flat = idx.astype(np.int64) + offsets[None, :, None]
    if signal_tables is not None:
        flat = flat[:, np.asarray(signal_tables, dtype=np.int64), :]
    n = flat.shape[1] * flat.shape[2]
    return alpha * w[flat].sum(axis=(1, 2)) / np.sqrt(n)


def planted_labels(cfg, idx: np.ndarray, w: np.ndarray, rng,
                   alpha: float = 3.0, signal_tables=None):
    """(logits, labels): Bernoulli(sigmoid(logit)) draws — the label NOISE
    is what keeps the Bayes AUC below 1.0 and makes the ceiling honest."""
    logits = planted_logits(cfg, idx, w, alpha=alpha,
                            signal_tables=signal_tables)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(idx.shape[0]) < p).astype(np.float32)
    return logits, y


def make_holdout(cfg, w: np.ndarray, n_batches: int = 8, batch: int = 512,
                 seed: int = 91, alpha: float = 3.0, dense_seed: int = 92,
                 signal_tables=None):
    """Fixed held-out evaluation set: list of (idx, dense, logits, labels).
    Deterministic in (cfg, seed) so the train and serve jobs regenerate
    the SAME holdout independently."""
    rng = np.random.default_rng(seed)
    drng = np.random.default_rng(dense_seed)
    out = []
    for _ in range(n_batches):
        idx = zipf_batch(cfg, batch, rng)
        dense = (drng.random((batch, cfg.dense_dim), dtype=np.float32)
                 if cfg.dense_dim else None)
        logits, y = planted_labels(cfg, idx, w, rng, alpha=alpha,
                                   signal_tables=signal_tables)
        out.append((idx, dense, logits, y))
    return out


def bayes_auc(holdout) -> float:
    """AUC of the TRUE logits — the ceiling any model can reach."""
    from deeprecsys_tpu_torch.utils.metrics_ml import auc

    logits = np.concatenate([h[2] for h in holdout])
    y = np.concatenate([h[3] for h in holdout])
    return auc(logits, y.astype(int))


def eval_model_auc(apply_fn, params, cfg, holdout, device="cuda") -> float:
    """Holdout ROC-AUC of ``apply_fn(params, batch)`` scores."""
    from deeprecsys_tpu_torch.models.base import Batch
    from deeprecsys_tpu_torch.utils.metrics_ml import auc

    scores, ys = [], []
    with torch.inference_mode():
        for idx, dense, _logits, y in holdout:
            out = apply_fn(params, Batch(dense=dense, indices=idx).to(device))
            scores.append(out.float()[:, 0].cpu().numpy())
            ys.append(y)
    return auc(np.concatenate(scores), np.concatenate(ys).astype(int))


def train_planted(cfg, steps: int = 600, batch: int = 512, eval_every: int = 50,
                  alpha: float = 3.0, lr: float = 0.01, table_lr: float = 1e-3,
                  seed: int = 0, stream_seed: int = 7, holdout_batches: int = 8,
                  log=print, signal_tables=None, device="cuda"):
    """Train ``cfg`` with the sparse touched-rows trainer on the planted
    zipf stream; returns ``(trainer, report)``. The report holds the JAX
    module's fields and ``train_s``/``steps_per_s``: the wall of the steps
    (each batch drawn on the host, the step, its loss read back), evaluations
    excluded. ``table_lr`` 1e-3 (the JAX default): zipf(1.2)'s head row is
    in ~19% of all lookups, so a larger rate saturates the sigmoid at once
    (JAX ``train_quality.py:139-151``)."""
    from deeprecsys_tpu_torch.models.base import Batch
    from deeprecsys_tpu_torch.train import Trainer

    w = planted_weights(cfg)
    holdout = make_holdout(cfg, w, n_batches=holdout_batches, batch=batch,
                           alpha=alpha, signal_tables=signal_tables)
    ceiling = bayes_auc(holdout)
    tr = Trainer(cfg, sparse_tables=True, optimizer="adagrad", learning_rate=lr,
                 table_learning_rate=table_lr, loss="bce", seed=seed, device=device)
    rng = np.random.default_rng(stream_seed)
    lrng = np.random.default_rng(stream_seed + 1)
    drng = np.random.default_rng(stream_seed + 2)
    losses, curve = [], []
    train_s = 0.0
    for i in range(steps):
        t0 = time.perf_counter()
        idx = zipf_batch(cfg, batch, rng)
        _, y = planted_labels(cfg, idx, w, lrng, alpha=alpha, signal_tables=signal_tables)
        dense = (drng.random((batch, cfg.dense_dim), dtype=np.float32)
                 if cfg.dense_dim else None)
        losses.append(float(tr.step(Batch(dense=dense, indices=idx), y)))
        train_s += time.perf_counter() - t0
        if eval_every and ((i + 1) % eval_every == 0 or i == 0):
            a = eval_model_auc(tr.model.apply, tr.params, cfg, holdout, tr.device)
            curve.append({"step": i + 1, "auc": round(a, 4),
                          "loss": round(float(np.mean(losses[-8:])), 4)})
            log(f"step {i + 1}: loss {curve[-1]['loss']:.4f}, "
                f"holdout AUC {a:.4f} (bayes {ceiling:.4f})")
    report = {
        "alpha": alpha, "steps": steps, "batch": batch,
        "lr": lr, "table_lr": table_lr,
        "loss_first8": round(float(np.mean(losses[:8])), 4),
        "loss_last8": round(float(np.mean(losses[-8:])), 4),
        "bayes_auc": round(ceiling, 4),
        "auc_curve": curve,
        "final_auc": curve[-1]["auc"] if curve else None,
        "holdout_n": holdout_batches * batch,
        "train_s": train_s,
        "steps_per_s": steps / train_s if train_s > 0 else None,
    }
    return tr, report


def main(argv=None):
    """Train one zoo model on the planted signal and write its report
    (``plots.plot_train_quality`` reads the file)."""
    import argparse
    import json
    from pathlib import Path

    from deeprecsys_tpu_torch import zoo

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--model", default="rm1")
    ap.add_argument("--table-scale", type=int, default=1)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/experiments/train_quality.json")
    args = ap.parse_args(argv)
    cfg = zoo.get_config(args.model, table_scale=args.table_scale)
    _, rep = train_planted(cfg, steps=args.steps, batch=args.batch,
                           eval_every=args.eval_every, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    recorded = json.loads(out.read_text()) if out.exists() else {}
    recorded[args.model] = rep
    out.write_text(json.dumps(recorded, indent=2))
    print(f"{args.model}: holdout AUC {rep['final_auc']} (bayes {rep['bayes_auc']}), "
          f"{rep['steps_per_s']:.1f} steps/s -> {out}")
    return rep


if __name__ == "__main__":
    main()
