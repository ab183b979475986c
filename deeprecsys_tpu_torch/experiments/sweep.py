"""Batch-size sweeps: the card's latency ladders for the sim engines.

Counterpart of ``deeprecsys_tpu/experiments/sweep.py:28-70`` (reference
``accelerator/generate_data.py``, which sweeps each model at batch
4^0..4^5 on the accelerator for the latency tables its simulated engine
interpolates). ``sweep_model`` times one model's forward at each batch size
of the ladder; ``main`` writes each model's ladder as ``gpu_<model>.json``
into the port's ``characterization/`` directory
(``serving/latency_model.py::CHAR_DIR``), in the ``LatencyModel`` schema
(``batch_sizes``, ``latencies_ms``, ``base``, ``table_scale``, ``dtype``,
``table_pack``) plus the card it was measured on: ``device`` and
``power_limit`` as ``nvidia-smi`` reports them. ``main.py --engine_backend
sim`` and ``experiments/qps_sweep.py`` read these files and no others.

What is timed: ``ITERS`` forwards back to back, cycling through
``DISTINCT`` batches generated apart, after a warm-up pass over them; CUDA
events around the loop on the card (``kernel_bench.wall_ms``). The JAX
sweep rolls one batch by a row a step instead; on the card that would read
the same embedding rows in every forward, which at rm1's batch 1024 (~42
MB of rows) the H100's 50 MB L2 could hold, while ``DISTINCT`` batches of
rows do not fit it. The loops of all batch sizes run in turns,
``REPEATS`` rounds, so drift of the host over the sweep hits every batch
size alike, and each point is the median ms a forward over its rounds. A
forward of the zoo's models is bound by the host's dispatch of its eager
ops at every batch of the ladder (PERF.md), so the ladder holds the
dispatch rate of one engine thread, which is what a sim engine should
reproduce.

Usage (on the card; ``--device cpu`` writes ``cpu_<model>.json``, which
the sim never reads):
    python -m deeprecsys_tpu_torch.experiments.sweep --models rm1
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

DEFAULT_BATCHES = (1, 4, 16, 64, 256, 1024)  # the reference's 4^0..4^5 ladder
ITERS = 50
REPEATS = 5
DISTINCT = 8  # batches generated apart at each batch size, cycled through


def card_identity(device: torch.device) -> tuple[str, str | None]:
    """``(name, power limit)`` of ``device`` as ``nvidia-smi`` gives them;
    ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    proc = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    name, power = (x.strip() for x in proc.stdout.strip().splitlines()[0].rsplit(",", 1))
    return name, power


def time_calls_in_turns(fn, args_lists, device: torch.device, iters: int = ITERS,
                        repeats: int = REPEATS) -> list[float]:
    """For each of ``args_lists``, the median ms a call of ``iters`` calls of
    ``fn`` back to back cycling through it (``kernel_bench.wall_ms``), after
    one warm-up pass of each; the lists' loops run in turns, ``repeats``
    rounds."""
    from deeprecsys_tpu_torch.kernel_bench import wall_ms

    cuda = device.type == "cuda"
    with torch.inference_mode():
        for args_list in args_lists:
            for a in args_list:
                fn(*a)
        rounds = [[wall_ms(fn, args_list, iters, cuda) for args_list in args_lists]
                  for _ in range(repeats)]
    return [float(np.median(col)) for col in zip(*rounds)]


def time_calls(fn, args_list, device: torch.device, iters: int = ITERS,
               repeats: int = REPEATS) -> float:
    """Median ms a call of ``iters`` calls of ``fn`` cycling through
    ``args_list``."""
    return time_calls_in_turns(fn, [args_list], device, iters, repeats)[0]


def sweep_model(name: str, device, batch_sizes=DEFAULT_BATCHES, table_scale: int = 1,
                param_dtype: str = "bfloat16", iters: int = ITERS,
                table_pack: int = 0) -> dict:
    """Forward ms of zoo model ``name`` at each batch size, on ``device``."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.models import get_model
    from deeprecsys_tpu_torch.utils.devices import resolve_device

    device = resolve_device(str(device))
    cfg = zoo.get_config(name, table_scale=table_scale, param_dtype=param_dtype,
                         compute_dtype=param_dtype, table_pack=table_pack)
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen = RecDataGenerator(cfg, seed=0)
    args_lists = [[(params, gen.generate_batch(b).to(device)) for _ in range(DISTINCT)]
                  for b in batch_sizes]
    lat_ms = time_calls_in_turns(model.apply, args_lists, device, iters)
    del params, args_lists
    kind, power = card_identity(device)
    return {"model": name, "batch_sizes": list(batch_sizes), "latencies_ms": lat_ms,
            "dtype": param_dtype, "device": kind, "power_limit": power,
            "table_scale": table_scale, "table_pack": table_pack}


def ladder_json(r: dict) -> dict:
    """A ``sweep_model`` result as a ladder file's fields."""
    return {"batch_sizes": r["batch_sizes"], "latencies_ms": r["latencies_ms"], "base": 4.0,
            "table_scale": r["table_scale"], "dtype": r["dtype"],
            "table_pack": r["table_pack"], "device": r["device"],
            "power_limit": r["power_limit"]}


def main(argv=None):
    from deeprecsys_tpu_torch.serving.latency_model import CHAR_DIR

    ap = argparse.ArgumentParser(description="the card's latency ladders")
    ap.add_argument("--models", nargs="+",
                    default=["rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
    ap.add_argument("--batches", nargs="+", type=int, default=list(DEFAULT_BATCHES))
    ap.add_argument("--table-scale", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=str(CHAR_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = "gpu" if torch.device(args.device).type == "cuda" else "cpu"
    results = []
    for name in args.models:
        r = sweep_model(name, args.device, args.batches, args.table_scale, args.dtype)
        path = out_dir / f"{prefix}_{name}.json"
        path.write_text(json.dumps(ladder_json(r), indent=1) + "\n")
        print(f"{prefix} {name} ({r['device']}, {r['power_limit']}): " + " ".join(
            f"{b}:{ms:.4f}ms" for b, ms in zip(r["batch_sizes"], r["latencies_ms"]))
            + f" -> {path}", flush=True)
        results.append(r)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
