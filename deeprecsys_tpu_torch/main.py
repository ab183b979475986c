"""Command-line entry point, standalone mode (counterpart of
``deeprecsys_tpu/main.py:29-232, 308-406, 409-498``).

The parser carries the JAX package's flags that the port reads (model and
table choice, dtypes, the lookup knobs that ``model_config_from_args``
turns into a ``ModelConfig``, the standalone loop's sizes), with the same
names and defaults, plus ``--device``. The flags of modes not ported yet
(``--queue``, ``--serve``, ``--checkpoint``, ...) are accepted and raise
``NotImplementedError`` naming the ROADMAP.md item that ports them. The
run generates ``--num_batches`` batches, runs one warm-up forward, then
times ``--nepochs`` passes over the batches and prints the reference's
three ``***`` totals and the throughput. On a card the compute time is the
host clock between two ``torch.cuda.synchronize()`` calls around the whole
loop.

Example (on a machine with a CUDA card):
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 \\
      --num_batches 16 --mini_batch_size 512
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ModelConfig, load_model_config

# Flags of the JAX CLI whose paths are not ported yet, with the ROADMAP.md
# item that ports each.
_NOT_PORTED = {
    "queue": "Queue 1 item 11 (serving engines)",
    "serve": "Queue 1 item 11 (serving engines)",
    "checkpoint": "Queue 1 item 9 (trainer, checkpoints)",
    "score_output": "Queue 1 item 11 (offline scoring)",
    "enable_profiling": "Queue 1 item 13 (op breakdown through torch.profiler)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepRecSys on PyTorch + CUDA")
    p.add_argument("--model", type=str, default="rm1",
                   help=f"zoo model name {zoo.MODEL_NAMES} or path to a reference-format JSON")
    p.add_argument("--table_scale", type=int, default=1,
                   help="divide embedding-table rows (memory-constrained runs)")
    p.add_argument("--param_dtype", type=str, default="float32")
    p.add_argument("--compute_dtype", type=str, default=None,
                   help="default: --param_dtype")
    # Lookup knobs of ModelConfig; the port runs only "xla" (K1), unquantized.
    p.add_argument("--embedding_impl", type=str, default="xla",
                   choices=["xla", "hotcold", "auto"])
    p.add_argument("--hotcold_min_hit", type=float, default=None)
    p.add_argument("--hotcold_min_table_mb", type=float, default=128.0)
    p.add_argument("--table_pack", type=int, default=0,
                   help="the JAX package's row packing; the port keeps tables unpacked")
    p.add_argument("--hot_set_rows", type=int, default=0)
    p.add_argument("--table_quant", type=str, default="none",
                   choices=["none", "int8", "int8_rowwise"])
    p.add_argument("--output_head", type=str, default="reference",
                   choices=["reference", "logits"],
                   help="ncf/din/dien score head: 'reference' = FC+relu; "
                        "'logits' = the final FC's pre-activation")
    # Standalone characterization loop
    p.add_argument("--data_generation", type=str, default="random",
                   choices=["random", "synthetic", "dataset"])
    p.add_argument("--synthetic_data_trace_file", type=str, default=None)
    p.add_argument("--data_set", type=str, default="kaggle", choices=["kaggle", "criteo"])
    p.add_argument("--raw_data_file", type=str, default=None)
    p.add_argument("--num_batches", type=int, default=16)
    p.add_argument("--mini_batch_size", type=int, default=64)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--numpy_rand_seed", type=int, default=123)
    # Modes not ported yet (_NOT_PORTED)
    p.add_argument("--queue", action="store_true")
    p.add_argument("--serve", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--score_output", type=str, default=None)
    p.add_argument("--enable_profiling", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises when no card is present) or 'cpu'")
    return p


def _model_overrides(args) -> dict:
    overrides = {"param_dtype": args.param_dtype}
    if args.embedding_impl != "xla":
        overrides["embedding_impl"] = args.embedding_impl
        overrides["hot_set_rows"] = args.hot_set_rows
    if args.hotcold_min_hit is not None:
        overrides["hotcold_min_hit"] = args.hotcold_min_hit
    if args.hotcold_min_table_mb != 128.0:
        overrides["hotcold_min_table_mb"] = args.hotcold_min_table_mb
    if args.table_quant != "none":
        overrides["table_quant"] = args.table_quant
    if args.output_head != "reference":
        overrides["output_head"] = args.output_head
    overrides["table_pack"] = args.table_pack
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    elif args.param_dtype:
        overrides["compute_dtype"] = args.param_dtype
    return overrides


def model_config_from_args(args) -> ModelConfig:
    """The ModelConfig for ``--model`` and the lookup flags (JAX
    ``main.py:199-230``)."""
    overrides = _model_overrides(args)
    if args.model == "criteo":
        raise NotImplementedError("--model criteo (the Criteo dataset mode) is not "
                                  "ported yet (ROADMAP.md Queue 1 item 1)")
    if args.model in zoo.MODEL_NAMES:
        return zoo.get_config(args.model, table_scale=args.table_scale, **overrides)
    return load_model_config(args.model, table_scale=args.table_scale, **overrides)


def run_standalone(model_cfg: ModelConfig, args) -> dict:
    """Characterization loop: data-generation time apart from compute time,
    printed as the reference's three totals."""
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.utils.devices import resolve_device, synchronize

    device = resolve_device(args.device)
    model = get_model(model_cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.numpy_rand_seed)
    params = model.init(gen)
    data = RecDataGenerator(model_cfg, seed=args.numpy_rand_seed,
                            data_generation=args.data_generation)

    t0 = time.perf_counter()
    batches = data.generate_batches(args.num_batches, args.mini_batch_size)
    t_load = time.perf_counter() - t0
    dev = [b.to(device) for b in batches]

    with torch.inference_mode():
        model.apply(params, dev[0])  # warm-up, excluded from the total
        synchronize(device)
        t0 = time.perf_counter()
        outs = []
        for _ in range(args.nepochs):
            outs = [model.apply(params, b) for b in dev]
        synchronize(device)
        t_comp = time.perf_counter() - t0

    total_ms = (t_load + t_comp) * 1000.0
    print(f"Total data loading time: *** {t_load * 1000.0:.3f} ms")
    print(f"Total computation time: *** {t_comp * 1000.0:.3f} ms")
    print(f"Total execution time: *** {total_ms:.3f} ms")
    n = args.nepochs * args.num_batches * args.mini_batch_size
    print(f"Throughput: {n / (t_load + t_comp):.1f} samples/s")
    sys.stdout.flush()
    return {"load_ms": t_load * 1000.0, "compute_ms": t_comp * 1000.0,
            "total_ms": total_ms, "forwards": 1 + args.nepochs * args.num_batches,
            "outputs": outs, "device": str(device)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md {item})")
    model_cfg = model_config_from_args(args)
    print(f"[deeprecsys_tpu_torch] model={model_cfg.model_name} "
          f"type={model_cfg.model_type} tables={model_cfg.num_tables} "
          f"rows={model_cfg.total_rows} L={model_cfg.num_indices_per_lookup} "
          f"device={args.device}")
    return run_standalone(model_cfg, args)


if __name__ == "__main__":
    main()
