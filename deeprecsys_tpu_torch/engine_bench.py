"""Closed-loop capacity of the serving engines: how many model executions a
second a pool of engine threads in one process sustains when its queue is
never empty, and what an execution costs the host.

    python -m deeprecsys_tpu_torch.engine_bench [--engines 1 2 4]
        [--switch_interval 0.005 0.0005] [--table_quant int8]
        [--embedding_impl hotcold] [--device cuda] [--json PATH]

At each engine (thread) count and each ``sys.setswitchinterval`` value it
runs three arms on one set of rm1 params (bf16, full-size tables; int8
ones with ``--table_quant``), every execution at 32 rows (a sub-batch of
the canonical serving point):

- ``engine``: the serving engines themselves (``build_engine_pool``, one
  bucket), their request queue filled with ``--executions`` requests; on a
  card each engine replays the CUDA graph of its bucket it captured at
  warm-up (``serving/programs.py``), with its copies in and out;
- ``eager``: each thread a bare loop on its own stream: the forward, a
  non-blocking copy of the scores into pinned memory, an event and a wait
  on it, with no queue and no second thread an engine;
- ``graph``: the same loop replaying one CUDA graph of the forward a
  thread (captured one thread at a time before the timed window), so an
  execution is one call into PyTorch instead of one a device op: the
  engine's replay without its queue, copies and second thread.

With ``--embedding_impl hotcold`` the engines split every request on the
host and pool it with K6 (their hot set sampled at set-up), and only the
``engine`` arm runs: the loops have no split.

Each row gives executions a second over the pool, the process's context
switches and CPU seconds an execution (``getrusage``), and, for
``engine``, the median time from dispatch to readable scores. A pool whose
rate falls as threads are added loses to the host, not to the card.

``--device cpu`` runs the ``engine`` and ``eager`` arms on the host (no
``graph``), to compare with the JAX package's thread engines on the same
host (``python -m tests.engine_scaling``); it is named as such in every
row. With the default ``--device cuda`` it raises without a card. It
imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import resource
import statistics
import sys
import threading
import time

import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.serving.engine import build_engine_pool
from deeprecsys_tpu_torch.serving.packets import ServiceRequest
from deeprecsys_tpu_torch.utils.devices import resolve_device


def _usage() -> tuple[float, float]:
    """(context switches, CPU seconds) of this process so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_nvcsw + r.ru_nivcsw, r.ru_utime + r.ru_stime


def _row(arm: str, threads: int, n: int, seconds: float, usage0, usage1, **extra) -> dict:
    # Some sandboxed kernels do not count context switches: None, not 0.
    switches = (usage1[0] - usage0[0]) / n if usage1[0] else None
    return {"arm": arm, "threads": threads, "executions": n,
            "executions_per_s": n / seconds, "seconds": seconds,
            "ctx_switches_per_execution": switches,
            "cpu_ms_per_execution": (usage1[1] - usage0[1]) * 1000.0 / n, **extra}


def device_busy_ms(prof):
    """The union of the device intervals (kernels, copies) in a finished
    ``torch.profiler`` trace, ms; None if it holds none."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    return (busy + hi - lo) / 1e3


def engine_arm(model_cfg, backend: str, engines: int, n: int, rows: int, params=None,
               pool_fn=build_engine_pool, config_cls=ServingConfig,
               request_cls=ServiceRequest, profile: bool = False) -> dict:
    """``n`` requests of ``rows`` rows through ``engines`` engines of
    ``pool_fn`` (the port's by default; the JAX package's takes the same
    arguments). Timed from the first request put to the last answer. With
    ``profile`` (a card) a ``torch.profiler`` trace of that window gives the
    device's busy ms and idle share (1 - busy / wall); tracing slows the
    host, so such a row's rate is not the untraced one."""
    scfg = config_cls(inference_engines=engines, engine_backend=backend,
                      batch_buckets=(rows,), max_mini_batch_size=rows)
    request_q, accel_q, response_q, ready_q = (queue.Queue() for _ in range(4))
    pool, total = pool_fn(model_cfg, scfg, request_q, accel_q, response_q, ready_q,
                          params=params)
    for e in pool:
        e.start()
    for _ in range(total):
        item = ready_q.get(timeout=600)
        if isinstance(item, Exception):
            raise RuntimeError("an engine failed during setup") from item
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                      acc_events=True)
        prof.start()
    usage0, t0 = _usage(), time.perf_counter()
    for i in range(n):
        request_q.put(request_cls(batch_id=i, batch_size=rows, arrival_time=time.time()))
    for _ in range(total):
        request_q.put(None)
    inference, done = [], 0
    while done < total:
        r = response_q.get(timeout=600)
        if r is None:
            done += 1
        elif r.error_code:
            raise RuntimeError(f"request {r.batch_id} answered with error {r.error_code}")
        else:
            inference.append(r.inference_end_time - r.queue_start_time)
    seconds, usage1 = time.perf_counter() - t0, _usage()
    extra = {}
    if prof is not None:
        prof.stop()
        busy = device_busy_ms(prof)
        extra = {"device_busy_ms": busy,
                 "idle_share": None if busy is None else 1.0 - busy / (seconds * 1000.0)}
    for e in pool:
        e.join()
        if getattr(e, "error", None) is not None:
            raise RuntimeError(f"{e.name} failed") from e.error
    if len(inference) != n:
        raise RuntimeError(f"{len(inference)} answers for {n} requests")
    return _row("engine", engines, n, seconds, usage0, usage1,
                inference_p50_ms=statistics.median(inference) * 1000.0, **extra)


def loop_arm(model, params, host_batch, device, threads: int, n: int, graph: bool) -> dict:
    """``threads`` bare loops of ``n`` executions each (see the module
    docstring), timed between two barriers that every thread reaches."""
    on_card = device.type == "cuda"
    if graph and not on_card:
        raise ValueError("CUDA graphs need a CUDA card")
    barrier = threading.Barrier(threads + 1)
    setup_lock = threading.Lock()  # one thread at a time sets up (and captures)
    errors: list[BaseException] = []

    def work():
        try:
            with torch.inference_mode():
                with setup_lock:
                    stream = torch.cuda.Stream(device) if on_card else None

                    def on_stream():
                        return (torch.cuda.stream(stream) if on_card
                                else contextlib.nullcontext())

                    with on_stream():
                        batch = host_batch.to(device)
                        out = model.apply(params, batch)
                        scores = torch.empty(out.shape, dtype=out.dtype, pin_memory=on_card)
                        if on_card:
                            stream.synchronize()
                        replay = None
                        if graph:
                            g = torch.cuda.CUDAGraph()
                            with torch.cuda.graph(g, stream=stream,
                                                  capture_error_mode="thread_local"):
                                out = model.apply(params, batch)
                            replay = g.replay
                            replay()
                            stream.synchronize()
                barrier.wait()
                with on_stream():
                    for _ in range(n):
                        if replay is not None:
                            replay()
                        else:
                            out = model.apply(params, batch)
                        scores.copy_(out, non_blocking=on_card)
                        if on_card:
                            event = torch.cuda.Event()
                            event.record(stream)
                            event.synchronize()
                barrier.wait()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
            barrier.abort()

    workers = [threading.Thread(target=work, daemon=True) for _ in range(threads)]
    for w in workers:
        w.start()
    try:
        barrier.wait()
        usage0, t0 = _usage(), time.perf_counter()
        barrier.wait()
        seconds, usage1 = time.perf_counter() - t0, _usage()
    except threading.BrokenBarrierError:
        pass
    for w in workers:
        w.join()
    if errors:
        raise RuntimeError("a loop thread failed") from errors[0]
    return _row("graph" if graph else "eager", threads, threads * n, seconds, usage0, usage1)


def describe(r: dict) -> str:
    """One row as text."""
    switches = r["ctx_switches_per_execution"]
    return (f"{r['executions_per_s']:.1f} exec/s, "
            + ("context switches not counted here" if switches is None
               else f"{switches:.2f} context switches")
            + f" and {r['cpu_ms_per_execution']:.3f} CPU ms an execution"
            + (f", inference p50 {r['inference_p50_ms']:.3f} ms"
               if "inference_p50_ms" in r else "")
            + (f", device idle {r['idle_share']:.1%} of the traced window"
               if r.get("idle_share") is not None else ""))


def card_line() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def run(engines=(1, 2, 4), intervals=(0.005,), executions: int = 2000,
        device: str = "cuda", table_scale: int = 1, model: str = "rm1", rows: int = 32,
        table_quant: str = "none", embedding_impl: str = "xla") -> dict:
    dev = resolve_device(device)
    cfg = zoo.get_config(model, table_scale=table_scale, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=table_quant,
                         embedding_impl=embedding_impl)
    fns = get_model(cfg.replace(embedding_impl="xla"), dev)
    params = fns.init(torch.Generator(device=dev).manual_seed(0))
    host_batch = RecDataGenerator(cfg, seed=17).generate_batch(rows)
    where = card_line() if dev.type == "cuda" else "host CPU (not a device measurement)"
    arms = ("engine", "eager", "graph") if dev.type == "cuda" else ("engine", "eager")
    if embedding_impl != "xla":
        arms = ("engine",)
    rows_out = []
    default_interval = sys.getswitchinterval()
    try:
        for interval in intervals:
            sys.setswitchinterval(interval)
            for k in engines:
                for arm in arms:
                    if arm == "engine":
                        r = engine_arm(cfg, "gpu" if dev.type == "cuda" else "cpu", k,
                                       executions, rows, params=params)
                    else:
                        r = loop_arm(fns, params, host_batch, dev, k, max(1, executions // k),
                                     graph=arm == "graph")
                    r["switch_interval_s"] = interval
                    rows_out.append(r)
                    print(f"[engine_bench] {model} tables={table_quant} "
                          f"lookup={embedding_impl} rows={rows} "
                          f"switch={interval} "
                          f"{arm:6s} threads={k}: {describe(r)} [{where}]", flush=True)
    finally:
        sys.setswitchinterval(default_interval)
    return {"model": model, "rows": rows, "table_scale": table_scale,
            "table_quant": table_quant, "embedding_impl": embedding_impl, "device": where,
            "torch": torch.__version__, "rows_by_arm": rows_out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--engines", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--switch_interval", type=float, nargs="+", default=[0.005])
    p.add_argument("--executions", type=int, default=2000)
    p.add_argument("--table_scale", type=int, default=1)
    p.add_argument("--table_quant", default="none", choices=["none", "int8", "int8_rowwise"])
    p.add_argument("--embedding_impl", default="xla", choices=["xla", "hotcold"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    out = run(tuple(args.engines), tuple(args.switch_interval), args.executions,
              args.device, args.table_scale, table_quant=args.table_quant,
              embedding_impl=args.embedding_impl)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
