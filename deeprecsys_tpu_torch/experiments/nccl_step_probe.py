"""A trainer's step across processes of a card each: its captured program
against its eager step, timed in turns, with a device trace of each.

    python -m deeprecsys_tpu_torch.experiments.nccl_step_probe \
        [--procs 2] [--meshes 1x2] [--modes dense,sparse,sparse_bf16] \
        [--arms graphed,eager] [--backend nccl] [--steps 20] [--trace 5] \
        [--env NAME=VALUE ...] [--table_scale 1] [--device cuda] [--json PATH]

Spawns ``--procs`` processes, process r on card r, joined over
``--backend``. Each builds rm1 at full size (batch 128, adagrad) on every
mesh of ``--meshes`` (``DxM``, the mesh's entries spread over the
processes) in every mode (``dense``; ``sparse``: the tables stepped by K5's
window; ``sparse_bf16``: the same with bf16 params), as two trainers from
the same weights: ``graphed`` (``Trainer.step`` after
``Trainer.take_programs``, since a trainer across processes is built eager:
the first step eager, then one graph of the step with its collectives,
replayed) and
``eager`` (the trainer's step function called eagerly). After two warm-up
steps of each arm, the arms are timed in turns (graphed, eager, eager,
graphed; ``--steps`` steps a turn), every process entering each turn
together (``torch.distributed.barrier``, then the card synchronised): a
step's time is the host clock around the step and the read of its loss,
since any process that enters a turn late holds every other one in its
first collective. Then ``--trace`` steps of each arm under
``torch.profiler``: the device time a step by kernel, NCCL's apart.

``--device cpu --backend gloo --arms eager --table_scale 2000`` rehearses
the script on the host's processes.

``--arms eager`` builds only the eager trainer, which the port has had
since processes were first meshed, so the script can time an older tree
of the package (copy it there). ``--env`` sets a variable in each child
before its group is made (e.g. an ``NCCL_*`` setting).

Prints one line a path and one JSON object (also written to ``--json``)
with the card's name and power limit as ``nvidia-smi`` gives them. Needs
``--procs`` CUDA cards; exits non-zero with fewer. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

WAIT_S = 600      # the parent's bound on every child's answer
TURNS = ("graphed", "eager", "eager", "graphed")
BATCH = 128
LR = 0.01


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def turn_walls(arms: dict, args: list, steps: int, barrier, device) -> dict:
    """Each arm's step times (ms), timed in the turns of TURNS over the
    arms present: ``barrier()`` and a synchronised card before each turn,
    then ``steps`` steps cycling through ``args``, each timed on the host
    clock around the step and the read of its loss. Returns, by arm, the
    per-step times of all its turns in order and their median."""
    times = {arm: [] for arm in arms}
    for arm in (a for a in TURNS if a in arms):
        barrier()
        _sync(device)
        for i in range(steps):
            t0 = time.perf_counter()
            float(arms[arm](*args[i % len(args)]))
            times[arm].append((time.perf_counter() - t0) * 1e3)
    return {arm: {"median_ms": statistics.median(ts), "mean_ms": statistics.fmean(ts),
                  "ms": ts} for arm, ts in times.items()}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def traced(fn, args: list, steps: int, barrier, device) -> dict:
    """``steps`` steps of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activity): device µs a step in all and in NCCL's kernels, the largest
    kernels by device time, and the host ms a step under the trace."""
    from torch.profiler import ProfilerActivity, profile

    barrier()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            float(fn(*args[i % len(args)]))
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    total = sum(us for _, us, _ in rows)
    nccl = sum(us for key, us, _ in rows if "nccl" in key.lower())
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return {"host_ms": wall, "device_us": total / steps, "nccl_us": nccl / steps,
            "top": [{"name": k[:90], "us": us / steps, "calls": n / steps} for k, us, n in top]}


def _path(device, mesh, mode: str, a: dict, barrier) -> dict:
    from deeprecsys_tpu_torch import train as port_train
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models import get_model

    sparse, bf16 = mode != "dense", mode == "sparse_bf16"
    arms_wanted = tuple(a["arms"])
    cfg = zoo.get_config("rm1", table_scale=a["table_scale"],
                         **(dict(param_dtype="bfloat16") if bf16 else {}))
    start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    kw = dict(optimizer="adagrad", learning_rate=LR, sparse_tables=sparse, params=start)
    ev = port_train.Trainer(cfg, mesh=mesh, **kw)
    tr = port_train.Trainer(cfg, mesh=mesh, **kw) if "graphed" in arms_wanted else None
    del start
    gen = RecDataGenerator(cfg, seed=1)
    args = [(h, ev._labels(h, None)) for h in (gen.generate_batch(BATCH) for _ in range(8))]

    def eager(h, lab):
        return ev._step(ev.params, ev.opt_state, h.to(device), ev._targets(lab))

    arms = {"eager": eager}
    out = {"eager_reason": None if tr is None else tr.eager_reason}
    if tr is not None:
        if tr.step_program is None:  # built eager (train_programs.NCCL_SLOWER)
            tr.take_programs()
        arms["graphed"] = lambda h, lab: tr.step(h, lab)
    for fn in arms.values():  # warm-up: the graphed arm's first step builds its program
        for h, lab in args[:2]:
            float(fn(h, lab))
    out["walls"] = turn_walls(arms, args, a["steps"], barrier, device)
    if a["trace"]:
        out["trace"] = {arm: traced(fn, args, a["trace"], barrier, device)
                        for arm, fn in arms.items()}
    if tr is not None:
        progs = tr.step_program
        out.update(captures=progs.captures, capture_ms=progs.capture_ms,
                   pool_mib=progs.pool_bytes() / 2**20)
    del tr, ev
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def child(rank: int, a: dict, port: int, q):
    """Process ``rank`` on card ``rank``: joins the group, runs every path,
    puts ``(rank, "ok", results)`` or ``(rank, "error", traceback)``."""
    import torch.distributed as dist

    try:
        for kv in a["env"]:
            k, v = kv.split("=", 1)
            os.environ[k] = v
        from deeprecsys_tpu_torch.parallel import distributed_init, make_mesh

        device = torch.device("cuda", rank) if a["device"] == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        distributed_init(f"127.0.0.1:{port}", num_processes=a["procs"], process_id=rank,
                         backend=a["backend"])

        def barrier():
            if device.type == "cuda" and a["backend"] == "nccl":
                dist.barrier(device_ids=[rank])
            else:
                dist.barrier()

        out = {}
        for spec in a["meshes"]:
            D, M = (int(x) for x in spec.split("x"))
            mesh = make_mesh(D, M, devices=[device])
            for mode in a["modes"]:
                out[f"rm1 {mode} {spec}"] = _path(device, mesh, mode, a, barrier)
        q.put((rank, "ok", out))
    except Exception:
        q.put((rank, "error", traceback.format_exc()[-4000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(a: dict) -> dict:
    """Spawn the children, gather their results by rank; on a failure or
    after WAIT_S kill them all, so none waits in a collective."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=child, args=(r, a, port, q)) for r in range(a["procs"])]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + WAIT_S
        for _ in procs:
            rank, status, detail = q.get(timeout=max(1.0, deadline - time.monotonic()))
            if status != "ok":
                raise RuntimeError(f"process {rank} failed:\n{detail}")
            results[rank] = detail
    finally:
        failed = len(results) < len(procs)
        for p in procs:
            if failed:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return {key: [results[r][key] for r in sorted(results)] for key in results[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--meshes", default="1x2")
    ap.add_argument("--modes", default="dense,sparse,sparse_bf16")
    ap.add_argument("--arms", default="graphed,eager")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", type=int, default=5)
    ap.add_argument("--env", action="append", default=[])
    ap.add_argument("--table_scale", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None)
    ns = ap.parse_args(argv)
    if ns.device == "cuda" and (not torch.cuda.is_available()
                                or torch.cuda.device_count() < ns.procs):
        print(f"needs {ns.procs} CUDA cards", file=sys.stderr)
        return 1
    a = dict(procs=ns.procs, meshes=ns.meshes.split(","), modes=ns.modes.split(","),
             arms=ns.arms.split(","), backend=ns.backend, steps=ns.steps, trace=ns.trace,
             env=ns.env, table_scale=ns.table_scale, device=ns.device)
    card = "the host's CPU" if ns.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    paths = run(a)
    for key, rs in paths.items():
        walls = "; ".join(
            f"{arm} median " + ", ".join(f"{r['walls'][arm]['median_ms']:.4f}" for r in rs)
            + " mean " + ", ".join(f"{r['walls'][arm]['mean_ms']:.4f}" for r in rs)
            for arm in rs[0]["walls"])
        tr = "; ".join(
            f"{arm} traced device {rs[0]['trace'][arm]['device_us']:.1f} us a step "
            f"(nccl {rs[0]['trace'][arm]['nccl_us']:.1f}), host {rs[0]['trace'][arm]['host_ms']:.4f} ms"
            for arm in rs[0].get("trace", {}))
        print(f"{key} over {a['procs']} processes ({a['backend']}{', ' if a['env'] else ''}"
              f"{' '.join(a['env'])}): ms a step by process, {walls}; process 0 {tr} [{card}]")
    doc = {"card": card, "args": a, "seconds": time.perf_counter() - t0, "paths": paths}
    if ns.json:
        Path(ns.json).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.json).write_text(json.dumps(doc, indent=1))
    print(json.dumps({"card": card, "args": a, "seconds": doc["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
