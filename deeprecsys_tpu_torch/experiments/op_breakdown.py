"""Per-stage runtime breakdown of each model.

Counterpart of ``deeprecsys_tpu/experiments/op_breakdown.py:65``
(reference ``experiments/operator_breakdown/sweep_p.py``, which profiles
every model at batch 4^0..4^5 and sums per-op runtimes). Each stage runs
alone at the shapes the full model gives it, as the JAX module times it:
the embedding lookup (``table_pack=1``, the plain fused layout; K1 on the
card), the bottom MLP, the interaction, the top MLP, MT-WnD's task heads,
DIN's stacked attention MLPs and DIEN's first scan (K3), then the full
model. A stage's time is ``sweep.time_calls``'s: back-to-back calls, CUDA
events around the loop on the card. The embedding stage and the full model
cycle through ``sweep.DISTINCT`` batches generated apart, so that their
rows do not stay in the card's L2 from one call to the next; the other
stages take their input rolled a row a call, as the JAX module does.

On the card the result also holds, from one ``torch.profiler`` pass over
the full model (``kernel_bench.measure``), the device µs a forward of each
kernel (``kernel_device_us``), the forward's device busy time and its wall.

Usage:
    python -m deeprecsys_tpu_torch.experiments.op_breakdown --models rm1 dien \\
        --batches 1 16 256
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from deeprecsys_tpu_torch.experiments.sweep import DISTINCT, time_calls

ITERS = 32


def _time_stage(fn, params, x, device, iters: int = ITERS) -> float:
    """ms a call of ``fn(params, x)``: ``x`` a list of inputs, cycled
    through, or a tensor, rolled by the call's index."""
    xs = x if isinstance(x, list) else [torch.roll(x, i, dims=0) for i in range(iters)]
    return time_calls(fn, [(params, v) for v in xs], device, iters)


def breakdown_for(name: str, batch_size: int, table_scale: int,
                  param_dtype: str = "float32", device="cuda") -> dict:
    """Stage times (ms) of zoo model ``name`` at ``batch_size`` on ``device``."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.models.base import compute_dtype_of, stacked_mlp_apply, table_offsets
    from deeprecsys_tpu_torch.ops import (
        basic_rnn_scan, cat_interaction, dot_interaction, embedding_bag, mlp_apply)
    from deeprecsys_tpu_torch.utils.devices import resolve_device

    device = resolve_device(str(device))
    cfg = zoo.get_config(name, table_scale=table_scale, param_dtype=param_dtype,
                         compute_dtype=param_dtype, table_pack=1)
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen = RecDataGenerator(cfg, seed=0)
    batches = [gen.generate_batch(batch_size).to(device) for _ in range(DISTINCT)]
    batch = batches[0]
    offsets = table_offsets(cfg, device)
    cdt = compute_dtype_of(cfg)
    times: dict[str, float] = {}

    def emb_fn(t, i):
        return embedding_bag(t, offsets, i, compute_dtype=cdt)

    with torch.inference_mode():
        times["embedding"] = _time_stage(emb_fn, params["tables"],
                                         [b.indices for b in batches], device)
        pooled = emb_fn(params["tables"], batch.indices)
        top_sigmoid = len(cfg.ln_top) - 1
        if cfg.model_type == "dlrm":
            dense = batch.dense.to(cdt)
            times["bottom_mlp"] = _time_stage(mlp_apply, params["bot"], dense, device)
            dense_out = mlp_apply(params["bot"], dense)
            if cfg.interaction_op == "dot":
                def int_fn(d, e):
                    return dot_interaction(d, e, self_interaction=cfg.interaction_itself)
            else:
                int_fn = cat_interaction
            times["interaction"] = _time_stage(int_fn, dense_out, pooled, device)
            z = int_fn(dense_out, pooled)
            times["top_mlp"] = _time_stage(
                lambda p, x: mlp_apply(p, x, sigmoid_layer=top_sigmoid), params["top"], z, device)
        elif cfg.model_type in ("wnd", "mtwnd"):
            dense = batch.dense.to(cdt)
            times["interaction"] = _time_stage(cat_interaction, dense, pooled, device)
            z = cat_interaction(dense, pooled)
            times["top_mlp"] = _time_stage(mlp_apply, params["top"], z, device)
            if cfg.model_type == "mtwnd":
                shared = mlp_apply(params["top"], z)
                x = shared[:, None, :].expand(shared.shape[0], cfg.num_multi_tasks,
                                              shared.shape[1])
                times["task_heads"] = _time_stage(
                    lambda p, v: stacked_mlp_apply(p, v, sigmoid_layer=top_sigmoid),
                    params["tasks"], x, device)
        elif cfg.model_type == "ncf":
            zmlp = torch.cat([pooled[:, 2, :], pooled[:, 3, :]], dim=1)
            times["top_mlp"] = _time_stage(mlp_apply, params["mlp"], zmlp, device)
        elif cfg.model_type == "din":
            T = cfg.num_tables
            behavior, ad = pooled[:, 1:T - 2, :], pooled[:, T - 2, :]
            ad_b = ad[:, None, :].expand_as(behavior)
            att_in = torch.cat([behavior, ad_b, behavior + ad_b], dim=-1)
            times["attention"] = _time_stage(stacked_mlp_apply, params["attention"], att_in,
                                             device)
            z = torch.zeros((batch_size, cfg.top_in_dim), dtype=pooled.dtype, device=device)
            times["top_mlp"] = _time_stage(mlp_apply, params["top"], z, device)
        elif cfg.model_type == "dien":
            T = cfg.num_tables
            seq = pooled[:, 1:T - 2, :].transpose(0, 1).contiguous()  # (T_b, B, m)
            # rolled along time, as the JAX module rolls axis 0
            times["rnn"] = _time_stage(lambda p, x: basic_rnn_scan(p, x)[1], params["rnn0"],
                                       seq, device)
            z = torch.zeros((batch_size, cfg.top_in_dim), dtype=pooled.dtype, device=device)
            times["top_mlp"] = _time_stage(mlp_apply, params["top"], z, device)
        times["full_model"] = _time_stage(model.apply, params, batches, device)
        kernels = None
        if device.type == "cuda":
            from deeprecsys_tpu_torch.kernel_bench import measure

            run = measure(model.apply, [(params, b) for b in batches], iters=20)
            kernels = {"kernel_device_us": run["us_by_kernel"],
                       "device_ms": run["device_ms"], "wall_ms": run["wall_ms"]}
    total_stage = sum(v for k, v in times.items() if k != "full_model")
    out = {
        "model": name,
        "batch": batch_size,
        "device": str(device),
        "stage_ms": times,
        "stage_fraction": {k: v / total_stage for k, v in times.items() if k != "full_model"},
        "fusion_gain": total_stage / times["full_model"] if times["full_model"] > 0 else None,
    }
    if kernels is not None:
        out.update(kernels)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-stage runtime breakdown")
    ap.add_argument("--models", nargs="+",
                    default=["rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 4, 16, 64, 256, 1024])
    ap.add_argument("--table-scale", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/experiments/op_breakdown.json")
    args = ap.parse_args(argv)
    rows = []
    for m in args.models:
        for b in args.batches:
            r = breakdown_for(m, b, args.table_scale, args.dtype, args.device)
            rows.append(r)
            us = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in r["stage_ms"].items())
            print(f"{m} b={b}: µs by stage: {us}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
