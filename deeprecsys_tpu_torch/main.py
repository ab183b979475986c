"""Command-line entry point, standalone mode (counterpart of
``deeprecsys_tpu/main.py:308-406, 409-498``).

The flags are the JAX package's own parser (``build_parser``) plus
``--device``. The run generates ``--num_batches`` batches, runs one warm-up
forward, then times ``--nepochs`` passes over the batches and prints the
reference's three ``***`` totals and the throughput. On a card the compute
time is the host clock between two ``torch.cuda.synchronize()`` calls
around the whole loop.

Example (on a machine with a CUDA card):
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 \\
      --num_batches 16 --mini_batch_size 512
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.main import build_parser as _jax_parser
from deeprecsys_tpu.main import model_config_from_args

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
    p = _jax_parser()
    p.description = "DeepRecSys on PyTorch + CUDA"
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises when no card is present) or 'cpu'")
    return p


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
