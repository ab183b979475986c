"""Command-line entry point (counterpart of ``deeprecsys_tpu/main.py``).

Three modes, as in the JAX package (reference ``DeepRecSys.py``):

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

Batches come from ``--data_generation``: ``random`` (the default),
``synthetic`` (stack-distance trace replay from
``--synthetic_data_trace_file``, ``data/trace.py``) or ``dataset`` (the
Criteo TSV ``--raw_data_file``; ``--model criteo`` is the 26-table DLRM
that matches its columns). In dataset mode ``--score_output`` writes the
scores of the file's rows in file order, cycling at its end.

``--enable_profiling`` traces the timed loop of standalone mode and the
``--queue`` run with ``torch.profiler`` (CPU ops, and the card's kernels on
a card): a Chrome trace goes into ``--profile_dir`` and the top ops of its
``key_averages()`` are printed. Without the flag the loop is untouched.

``--engine_backend sim`` (``--queue`` and ``--serve``) runs sleep-based
engines, the offload engine too, over the card's own latency ladder
``characterization/gpu_<model>.json`` (``experiments/sweep.py`` measures
it); it raises when that ladder is absent and never reads another
machine's ladder.

``--table_quant int8|int8_rowwise`` (both modes) serves int8 tables through
the kernels K1-int8 and K4. ``--queue --embedding_impl hotcold|auto`` serves
a hot/cold split of the lookups (K6, any table layout), with
``--hotcold_refresh_interval`` its adaptive refresh; standalone
``--embedding_impl hotcold`` raises, as in the JAX package, because the
split needs an engine's host splitter. ``--checkpoint <name>`` (both modes) starts
from a trained checkpoint (``<name>.npz`` + ``<name>.tree.json``, the JAX
package's format, e.g. from ``python -m deeprecsys_tpu_torch.train --save
<name>``) instead of random weights; with ``--table_quant`` it reads the
int8 bundle ``--export_quant`` writes (``<name>_int8_rowwise``, ...).

The parser carries the JAX package's flags that the port reads, with the
same names and defaults, but ``--engine_backend`` defaults to ``gpu``, and
adds ``--device``: the device of standalone mode and of the ``--model_accel``
offload engine (the card unless ``cpu`` is asked for). ``--engine_backend
cpu-mp`` runs CPU engine processes over shared-memory rings.

Examples (on a machine with a CUDA card; ``--engine_backend cpu`` or
``--device cpu`` for the host):
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 --queue \\
      --batch_size_distribution normal --avg_mini_batch_size 165 \\
      --var_mini_batch_size 16 --sub_task_batch_size 32 --num_batches 200
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 \\
      --num_batches 16 --mini_batch_size 512
  python -m deeprecsys_tpu_torch.main --model rm1 --param_dtype bfloat16 --serve \\
      --port 8321 --accept_ragged
  python -m deeprecsys_tpu_torch.main --model criteo --data_generation dataset \\
      --raw_data_file train.txt --mini_batch_size 512 --num_batches 8 --score_output s.npz
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import (
    ModelConfig, ServingConfig, _parse_dims, load_model_config)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepRecSys on PyTorch + CUDA")
    p.add_argument("--model", type=str, default="rm1",
                   help=f"zoo model name {zoo.MODEL_NAMES} or path to a reference-format JSON")
    p.add_argument("--table_scale", type=int, default=1,
                   help="divide embedding-table rows (memory-constrained runs)")
    p.add_argument("--param_dtype", type=str, default="float32")
    p.add_argument("--compute_dtype", type=str, default=None,
                   help="default: --param_dtype")
    # Lookup knobs of ModelConfig: "xla" the direct lookup (K1, K1-int8,
    # K4); "hotcold" and "auto" serving engines only (--queue), K6.
    p.add_argument("--embedding_impl", type=str, default="xla",
                   choices=["xla", "hotcold", "auto"],
                   help="'hotcold': a hot/cold split of the lookups (--queue only); "
                        "'auto': the engines sample their stream at warm-up and split "
                        "iff the hot set's coverage >= --hotcold_min_hit")
    p.add_argument("--hotcold_min_hit", type=float, default=None,
                   help="least sampled coverage for --embedding_impl auto to split "
                        "(default: the config's)")
    p.add_argument("--hotcold_refresh_interval", type=int, default=0,
                   help="adaptive hot-set refresh: every N tracked executions, re-derive "
                        "the hot set from the live stream if its hit rate dropped (0 = off)")
    p.add_argument("--hotcold_refresh_margin", type=float, default=0.05,
                   help="refresh when live coverage falls this far below the reference")
    p.add_argument("--hotcold_refresh_window", type=int, default=16,
                   help="recent executions buffered for the hot-set re-derivation")
    p.add_argument("--hotcold_scan_budget", type=int, default=2_000_000,
                   help="most lookups the refresh scan reads from the window (<= 0: all)")
    p.add_argument("--hotcold_scan_sync", action="store_true",
                   help="run the refresh scan on the serve thread instead of the worker")
    p.add_argument("--hotcold_min_table_mb", type=float, default=128.0,
                   help="--embedding_impl auto splits only fused tables at least this big")
    p.add_argument("--accept_ragged", action="store_true",
                   help="engines take masked (ragged) payload requests")
    p.add_argument("--payload_arena_slots", type=int,
                   default=ServingConfig.payload_arena_slots,
                   help="cpu-mp: blob-arena slots, one an in-flight /v1/predict "
                        "sub-request; exhaustion answers 503")
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
    # Both --data_set values mean the Criteo display-advertising TSV.
    p.add_argument("--data_set", type=str, default="kaggle", choices=["kaggle", "criteo"])
    p.add_argument("--raw_data_file", type=str, default=None,
                   help="Criteo TSV for --data_generation dataset")
    p.add_argument("--num_batches", type=int, default=16)
    p.add_argument("--mini_batch_size", type=int, default=64)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--numpy_rand_seed", type=int, default=123)
    # Serving mode (reference: --queue) and the HTTP ingress
    p.add_argument("--queue", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="start the HTTP serving ingress instead of a load-generator run")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--serve_models", type=str, default=None,
                   help="comma-separated zoo models behind one ingress "
                        "(POST /v1/models/<name>/infer); default: just --model")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--reload_root", type=str, default=None,
                   help="directory the checkpoint paths of POST /v1/reload must lie "
                        "under; required for reloads on a non-loopback --host")
    p.add_argument("--inference_engines", type=int, default=1)
    p.add_argument("--engine_backend", type=str, default="gpu",
                   choices=("gpu", "cpu", "cpu-mp", "sim"),
                   help="'gpu' (the CUDA card; raises without one), 'cpu', 'cpu-mp' "
                        "(CPU engine processes) or 'sim' (sleeps over the card's own "
                        "latency ladder, characterization/gpu_<model>.json)")
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
                   help="add a big-query offload engine on --device")
    p.add_argument("--accel_request_size_thres", type=int, default=1024)
    p.add_argument("--coalesce_requests", action="store_true",
                   help="engines drain waiting requests into one bucket execution")
    p.add_argument("--max_coalesce", type=int, default=8)
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--debug_mode", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="start from this trained checkpoint (<path>.npz + "
                        "<path>.tree.json; an int8 bundle with --table_quant) instead of "
                        "random weights: standalone, --queue and --serve (--model only)")
    p.add_argument("--score_output", type=str, default=None,
                   help="standalone mode: write the last epoch's scores to this .npz "
                        "(offline batch scoring)")
    p.add_argument("--enable_profiling", action="store_true",
                   help="trace the timed loop (standalone) or the run (--queue) with "
                        "torch.profiler into --profile_dir")
    p.add_argument("--profile_dir", type=str, default="log/profile")
    p.add_argument("--device", type=str, default="cuda",
                   help="standalone mode and the --model_accel offload engine: 'cuda' "
                        "(default; raises when no card is present) or 'cpu'")
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


def model_config_from_args(args, name: str | None = None) -> ModelConfig:
    """The ModelConfig for ``--model`` (or ``name``) and the lookup flags
    (JAX ``main.py:199-230``)."""
    name = args.model if name is None else name
    overrides = _model_overrides(args)
    if name == "criteo":
        from deeprecsys_tpu_torch.data.criteo import criteo_model_config

        return criteo_model_config().replace(table_scale=args.table_scale, **overrides)
    if name in zoo.MODEL_NAMES:
        return zoo.get_config(name, table_scale=args.table_scale, **overrides)
    return load_model_config(name, table_scale=args.table_scale, **overrides)


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
        hotcold_refresh_margin=args.hotcold_refresh_margin,
        hotcold_refresh_window=args.hotcold_refresh_window,
        hotcold_scan_budget=args.hotcold_scan_budget,
        hotcold_scan_async=not args.hotcold_scan_sync,
        accept_ragged=args.accept_ragged,
        payload_arena_slots=args.payload_arena_slots,
        seed=args.numpy_rand_seed,
        log_file=args.log_file,
        debug_mode=args.debug_mode,
    )


def _calibrated_latency_model(model_cfg: ModelConfig):
    """The sim engines' latency model: the ladder measured on the card for
    this model (``serving/latency_model.py::load_card_ladder``); raises when
    there is none."""
    from deeprecsys_tpu_torch.serving.latency_model import card_ladder_path, load_card_ladder

    lm, fields = load_card_ladder(model_cfg.model_name)
    print(f"[deeprecsys_tpu_torch] sim engines calibrated from "
          f"{card_ladder_path(model_cfg.model_name)} ({fields.get('device')}, "
          f"{fields.get('power_limit')}, {fields.get('dtype')}, "
          f"table_scale {fields.get('table_scale')})", flush=True)
    return lm


def _profiler(args, on_card: bool):
    """A ``torch.profiler.profile`` for ``--enable_profiling`` (the card's
    kernels too when ``on_card``), or None without the flag."""
    if not args.enable_profiling:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _report_profile(prof, args, model_cfg: ModelConfig, on_card: bool) -> str:
    """Write ``prof``'s Chrome trace into ``--profile_dir`` and print its
    top ops (by device time on a card); returns the trace's path."""
    os.makedirs(args.profile_dir, exist_ok=True)
    mode = "queue" if args.queue else "standalone"
    path = os.path.join(args.profile_dir, f"{model_cfg.model_name}_{mode}_{os.getpid()}_"
                                          f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    key = "self_device_time_total" if on_card else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=12))
    print(f"[deeprecsys_tpu_torch] profile trace written to {path}", flush=True)
    return path


def run_queue(model_cfg: ModelConfig, args):
    """Serving mode: run the stack and print the reference's report."""
    from deeprecsys_tpu_torch.serving import run_serving

    lm = _calibrated_latency_model(model_cfg) if args.engine_backend == "sim" else None
    if args.engine_backend == "gpu" and args.inference_engines > 1:
        print(f"[deeprecsys_tpu_torch] WARNING: {args.inference_engines} engine threads "
              "share one interpreter: each engine replays CUDA graphs, but its copies, "
              "replays and queue hand-offs still take turns on the GIL. On an H100 four "
              "rm1 engines served the canonical point at p95 10.3-60.0 ms against one "
              "engine's 3.3-7.2 ms, and sustained fewer executions a second than one "
              "(engine_bench; PERF.md). Use --inference_engines 1.", flush=True)
    on_card = args.engine_backend == "gpu" or (
        args.model_accel and lm is None and args.device != "cpu")
    prof = _profiler(args, on_card)
    with prof if prof is not None else contextlib.nullcontext():
        # In sim mode the offload engine is simulated too, as in the JAX
        # package (the reference's accelerator is always simulated).
        res = run_serving(model_cfg, serving_config_from_args(args), latency_model=lm,
                          accel_latency_model=lm, log_responses=args.log_file is not None,
                          checkpoint_path=args.checkpoint, accel_device=args.device)
    if prof is not None:
        _report_profile(prof, args, model_cfg, on_card)
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
                            data_generation=args.data_generation,
                            trace_file=args.synthetic_data_trace_file,
                            raw_data_file=args.raw_data_file)

    t0 = time.perf_counter()
    batches = data.generate_batches(args.num_batches, args.mini_batch_size)
    t_load = time.perf_counter() - t0
    dev = [b.to(device) for b in batches]

    on_card = device.type == "cuda"
    prof = _profiler(args, on_card)
    with torch.inference_mode():
        model.apply(params, dev[0])  # warm-up, excluded from the total
        synchronize(device)
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            outs = []
            for _ in range(args.nepochs):
                outs = [model.apply(params, b) for b in dev]
            synchronize(device)
            t_comp = time.perf_counter() - t0

        forwards = 1 + args.nepochs * len(dev)
        if args.score_output:
            if not outs:  # --nepochs 0: score all the same
                outs = [model.apply(params, b) for b in dev]
                forwards += len(dev)
            scores = torch.cat([o.float() for o in outs]).cpu().numpy()
            np.savez(args.score_output, scores=scores)
            print(f"[deeprecsys_tpu_torch] wrote {scores.shape[0]} x {scores.shape[1]} "
                  f"scores to {args.score_output}", flush=True)

    total_ms = (t_load + t_comp) * 1000.0
    print(f"Total data loading time: *** {t_load * 1000.0:.3f} ms")
    print(f"Total computation time: *** {t_comp * 1000.0:.3f} ms")
    print(f"Total execution time: *** {total_ms:.3f} ms")
    n = args.nepochs * args.num_batches * args.mini_batch_size
    print(f"Throughput: {n / (t_load + t_comp):.1f} samples/s")
    sys.stdout.flush()
    trace = _report_profile(prof, args, model_cfg, on_card) if prof is not None else None
    return {"load_ms": t_load * 1000.0, "compute_ms": t_comp * 1000.0,
            "total_ms": total_ms, "forwards": forwards,
            "outputs": outs, "device": str(device), "profile_trace": trace}


def start_serve(model_cfg: ModelConfig, args):
    """The started HTTP ingress of ``--serve``: one ``ServingServer`` a model
    of ``--serve_models`` (default ``--model``), ``--checkpoint`` for
    ``--model``, the offload engine on ``--device``."""
    from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer

    serving_cfg = serving_config_from_args(args)
    names = args.serve_models.split(",") if args.serve_models else [model_cfg.model_name]
    registry = {}
    try:
        for name in names:
            cfg = model_cfg if name == model_cfg.model_name else model_config_from_args(args, name)
            # Sim engines, the offload engine's too, over the model's ladder.
            lm = _calibrated_latency_model(cfg) if args.engine_backend == "sim" else None
            registry[name] = ServingServer(
                cfg, serving_cfg, accel_device=args.device, latency_model=lm,
                accel_latency_model=lm,
                checkpoint_path=args.checkpoint if name == model_cfg.model_name else None)
            registry[name].start()
        ingress = HttpIngress(registry, host=args.host, port=args.port, default=names[0],
                              reload_root=args.reload_root)
    except BaseException:
        for server in registry.values():
            server.stop()
        raise
    ingress.start()
    host, port = ingress.address
    print(f"[deeprecsys_tpu_torch] serving on http://{host}:{port} "
          f"(POST /v1/infer, /v1/predict, /v1/reload; GET /v1/models, /v1/stats)", flush=True)
    return ingress


def run_serve(model_cfg: ModelConfig, args):
    """``--serve``: the ingress until SIGTERM or Ctrl-C."""
    ingress = start_serve(model_cfg, args)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    print("[deeprecsys_tpu_torch] shutting down serving", flush=True)
    ingress.stop()


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg = model_config_from_args(args)
    where = (f"engine_backend={args.engine_backend}" if args.queue or args.serve
             else f"device={args.device}")
    print(f"[deeprecsys_tpu_torch] model={model_cfg.model_name} "
          f"type={model_cfg.model_type} tables={model_cfg.num_tables} "
          f"rows={model_cfg.total_rows} L={model_cfg.num_indices_per_lookup} {where}")
    if args.serve:
        return run_serve(model_cfg, args)
    if args.queue:
        return run_queue(model_cfg, args)
    return run_standalone(model_cfg, args)


if __name__ == "__main__":
    main()
