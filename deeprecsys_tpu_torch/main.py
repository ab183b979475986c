"""Command-line entry point (counterpart of ``deeprecsys_tpu/main.py``).

Two modes, as in the JAX package (reference ``DeepRecSys.py``):

- ``--queue``: the serving stack (``serving.run_serving``): load generator,
  engines, aggregator and, with ``--tune_batch_qps``, DeepRecSched; prints
  the reference's ``Measured QPS`` / p95 / p99 lines and the
  ``ServingResult`` as JSON. Engines run on the CUDA card
  (``--engine_backend gpu``, the default; raises without a card) or on the
  host (``cpu``).
- standalone: generates ``--num_batches`` batches, runs one warm-up
  forward, then times ``--nepochs`` passes and prints the reference's three
  ``***`` totals and the throughput, on ``--device``. On a card the
  compute time is the host clock between two ``torch.cuda.synchronize()``
  calls around the whole loop.

``--checkpoint <name>`` (both modes) starts from a trained float checkpoint
(``<name>.npz`` + ``<name>.tree.json``, the JAX package's format, e.g. from
``python -m deeprecsys_tpu_torch.train --save <name>``) instead of random
weights; a quantized one (``--table_quant``) raises until int8 tables are
ported (ROADMAP.md Queue 1 item 8).

The parser carries the JAX package's flags that the port reads, with the
same names and defaults, but ``--engine_backend`` defaults to ``gpu``, and
adds ``--device`` (standalone mode). The flags of modes not ported yet
(``--serve``, ``--score_output``, ``--engine_backend sim``, ...) raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.

Examples (on a machine with a CUDA card; ``--engine_backend cpu`` or
``--device cpu`` for the host):
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 --queue \\
      --batch_size_distribution normal --avg_mini_batch_size 165 \\
      --var_mini_batch_size 16 --sub_task_batch_size 32 --num_batches 200
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 \\
      --num_batches 16 --mini_batch_size 512
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import (
    ModelConfig, ServingConfig, _parse_dims, load_model_config)

# Flags of the JAX CLI whose paths are not ported yet, with the ROADMAP.md
# item that ports each.
_NOT_PORTED = {
    "serve": "Queue 1 item 11b (HTTP ingress)",
    "score_output": "Queue 1 item 11b (offline scoring)",
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
    p.add_argument("--hotcold_refresh_interval", type=int, default=0,
                   help="hot/cold refresh (not ported: a value > 0 raises)")
    p.add_argument("--hotcold_min_table_mb", type=float, default=128.0)
    p.add_argument("--accept_ragged", action="store_true",
                   help="engines take masked (ragged) payload requests")
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
    # Serving mode (reference: --queue)
    p.add_argument("--queue", action="store_true")
    p.add_argument("--inference_engines", type=int, default=1)
    p.add_argument("--engine_backend", type=str, default="gpu",
                   choices=("gpu", "cpu", "cpu-mp", "sim"),
                   help="'gpu' (the CUDA card; raises without one) or 'cpu'")
    p.add_argument("--avg_arrival_rate", type=float, default=10.0, help="ms")
    p.add_argument("--target_latency", type=float, default=25.0, help="ms (p95 SLA)")
    p.add_argument("--batch_size_distribution", type=str, default="fixed")
    p.add_argument("--avg_mini_batch_size", type=float, default=64)
    p.add_argument("--var_mini_batch_size", type=float, default=1)
    p.add_argument("--max_mini_batch_size", type=int, default=1024)
    p.add_argument("--batch_dist_file", type=str, default=None)
    p.add_argument("--sub_task_batch_size", type=int, default=64)
    p.add_argument("--bucket_policy", type=str, default="static", choices=["static", "auto"])
    p.add_argument("--max_auto_buckets", type=int, default=6)
    p.add_argument("--req_granularity", type=int, default=64)
    p.add_argument("--tune_batch_qps", action="store_true")
    p.add_argument("--tune_accel_qps", action="store_true")
    p.add_argument("--batch_configs", type=str, default="32-64-128-256-512-1024")
    p.add_argument("--accel_configs", type=str, default="128-256-512")
    p.add_argument("--stable_region", type=float, default=0.10)
    p.add_argument("--min_arr_range", type=float, default=1.0)
    p.add_argument("--max_arr_range", type=float, default=100.0)
    p.add_argument("--arr_steps", type=int, default=20)
    p.add_argument("--sched_timeout", type=int, default=100)
    p.add_argument("--model_accel", action="store_true",
                   help="add a big-query offload engine on the card")
    p.add_argument("--accel_request_size_thres", type=int, default=1024)
    p.add_argument("--coalesce_requests", action="store_true",
                   help="engines drain waiting requests into one bucket execution")
    p.add_argument("--max_coalesce", type=int, default=8)
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--debug_mode", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="start from this trained float checkpoint (<path>.npz + "
                        "<path>.tree.json) instead of random weights: standalone and --queue")
    # Modes not ported yet (_NOT_PORTED)
    p.add_argument("--serve", action="store_true")
    p.add_argument("--score_output", type=str, default=None)
    p.add_argument("--enable_profiling", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="standalone mode: 'cuda' (default; raises when no card is "
                        "present) or 'cpu'")
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


def serving_config_from_args(args) -> ServingConfig:
    """The ServingConfig for the serving flags (JAX ``main.py:233-278``)."""
    return ServingConfig(
        num_batches=args.num_batches,
        nepochs=args.nepochs,
        avg_arrival_rate_ms=args.avg_arrival_rate,
        batch_size_distribution=args.batch_size_distribution,
        avg_mini_batch_size=args.avg_mini_batch_size,
        var_mini_batch_size=args.var_mini_batch_size,
        max_mini_batch_size=args.max_mini_batch_size,
        batch_dist_file=args.batch_dist_file,
        sub_task_batch_size=args.sub_task_batch_size,
        data_generation=args.data_generation,
        synthetic_trace_file=args.synthetic_data_trace_file,
        raw_data_file=args.raw_data_file,
        bucket_policy=args.bucket_policy,
        max_auto_buckets=args.max_auto_buckets,
        inference_engines=args.inference_engines,
        engine_backend=args.engine_backend,
        target_latency_ms=args.target_latency,
        req_granularity=args.req_granularity,
        tune_batch_qps=args.tune_batch_qps,
        tune_accel_qps=args.tune_accel_qps,
        batch_configs=_parse_dims(args.batch_configs),
        accel_configs=_parse_dims(args.accel_configs),
        stable_region=args.stable_region,
        min_arr_range=args.min_arr_range,
        max_arr_range=args.max_arr_range,
        arr_steps=args.arr_steps,
        sched_timeout=args.sched_timeout,
        model_accel=args.model_accel,
        accel_request_size_thres=args.accel_request_size_thres,
        coalesce_requests=args.coalesce_requests,
        max_coalesce=args.max_coalesce,
        hotcold_refresh_interval=args.hotcold_refresh_interval,
        accept_ragged=args.accept_ragged,
        seed=args.numpy_rand_seed,
        log_file=args.log_file,
        debug_mode=args.debug_mode,
    )


def run_queue(model_cfg: ModelConfig, args):
    """Serving mode: run the stack and print the reference's report."""
    from deeprecsys_tpu_torch.serving import run_serving

    if args.engine_backend == "sim":
        raise NotImplementedError(
            "--engine_backend sim needs the card's own latency ladders, which are "
            "not measured yet (ROADMAP.md Queue 1 item 13; the JAX package's "
            "benchmarks/characterization/tpu_*.json are TPU numbers)")
    if args.engine_backend == "gpu" and args.inference_engines > 1:
        print(f"[deeprecsys_tpu_torch] WARNING: {args.inference_engines} engine threads "
              "share one interpreter, and every eager PyTorch call hands the GIL to "
              "another engine: on an H100, four rm1 engines sustained half the "
              "executions a second of one, and at 100 queries/s their queue did not "
              "drain (engine_bench; PERF.md). Use --inference_engines 1.", flush=True)
    res = run_serving(model_cfg, serving_config_from_args(args),
                      log_responses=args.log_file is not None,
                      checkpoint_path=args.checkpoint)
    if res.engine_errors:
        raise RuntimeError(f"{len(res.engine_errors)} engine(s) failed during the run, "
                           f"so its latencies are not a measurement: {res.engine_errors}")
    print("Measured QPS: ", res.measured_qps)
    print("Measured p95 tail-latency: ", res.p95_ms, " ms")
    print("Measured p99 tail-latency: ", res.p99_ms, " ms")
    print(json.dumps(res.to_dict()))
    sys.stdout.flush()
    return res


def run_standalone(model_cfg: ModelConfig, args) -> dict:
    """Characterization loop: data-generation time apart from compute time,
    printed as the reference's three totals."""
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.utils.devices import resolve_device, synchronize

    device = resolve_device(args.device)
    model = get_model(model_cfg, device)
    if args.checkpoint:
        from deeprecsys_tpu_torch.utils.checkpoint import checkpoint_params

        params = checkpoint_params(model_cfg, args.checkpoint, device)
    else:
        params = model.init(torch.Generator(device=device).manual_seed(args.numpy_rand_seed))
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
    where = f"engine_backend={args.engine_backend}" if args.queue else f"device={args.device}"
    print(f"[deeprecsys_tpu_torch] model={model_cfg.model_name} "
          f"type={model_cfg.model_type} tables={model_cfg.num_tables} "
          f"rows={model_cfg.total_rows} L={model_cfg.num_indices_per_lookup} {where}")
    if args.queue:
        return run_queue(model_cfg, args)
    return run_standalone(model_cfg, args)


if __name__ == "__main__":
    main()
