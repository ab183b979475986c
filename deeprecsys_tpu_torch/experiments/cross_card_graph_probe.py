"""Can one CUDA graph, captured on card 0, hold work on card 1? A probe on
two cards or more of one host, for the mesh engines' programs
(``serving/programs.py``).

    python -m deeprecsys_tpu_torch.experiments.cross_card_graph_probe [--json PATH]

The capture runs on a stream of card 0 (``capture_error_mode=
"thread_local"``, a private pool); a stream of card 1 joins it by waiting on
an event recorded on the capturing stream and joins back the same way.
Three questions, each answered on its own capture, its error (if any)
recorded as the answer:

- ``alloc``: an op on card 1 inside the capture allocates its output there.
  Does the caching allocator take it, and from which pool (the capture's
  private pool belongs to card 0)?
- ``peer_copy``: ``Tensor.to(card 0, non_blocking=True)`` of a card-1
  tensor inside the capture (PyTorch's cross-device copy runs on the
  source card's current stream, behind a two-way event barrier with the
  destination card's): is it captured, and does the graph instantiate?
- ``replay``: the graph of both (card-1 work, the copy back, a card-0 sum)
  replayed on new inputs against the same ops run eagerly: bit for bit?

Beside them, the design the engines use (``per_card``): a graph a card, no
cross-card work inside, the copy between the replays as an eager
cross-device ``copy_``; checked bit for bit the same way. Each design that
replays is timed on the host (the median of 200 executions, each waited
for), at the probe's tiny shapes: what it measures is the calls, not the
work. Prints one JSON object (and writes it to ``--json``) with the card's
name and power limit as ``nvidia-smi`` gives them. Needs two CUDA cards;
exits non-zero with fewer. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

N = 1 << 16  # elements of the probe's tensors


def _error(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}".strip()[:400] + " | " + traceback.format_exc(limit=2)[-400:]


def _pool_of(t: torch.Tensor):
    """The pool id of the allocator segment that holds ``t``; None where the
    segment is in an ordinary pool."""
    ptr = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] == t.device.index and seg["address"] <= ptr < (
                seg["address"] + seg["total_size"]):
            pool = tuple(seg.get("segment_pool_id", ()))
            return list(pool) if pool and pool != (0, 0) else None
    return "not found"


def _host_ms(fn, n: int = 200) -> float:
    times = []
    for _ in range(n + 20):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times[20:])


def _capture(fn, pool):
    """``fn()`` captured on the current card's current stream into
    ``pool``; returns ``(graph, out)``. A capture that fails raises after
    ending."""
    g = torch.cuda.CUDAGraph()
    g.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        out = fn()
    except BaseException:
        try:
            g.capture_end()
        except RuntimeError:
            pass
        raise
    g.capture_end()
    return g, out


def probe() -> dict:
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    s0, s1 = torch.cuda.Stream(c0), torch.cuda.Stream(c1)
    res: dict = {"peer_access": torch.cuda.can_device_access_peer(0, 1)}
    gen = torch.Generator(device="cpu").manual_seed(0)
    x0 = torch.rand(N, generator=gen).to(c0)
    x1 = torch.rand(N, generator=gen).to(c1)

    def card1_work():
        """Card 1 joins the capture, computes, and card 0 joins it back."""
        ev = torch.cuda.Event()
        ev.record(s0)
        s1.wait_event(ev)
        with torch.cuda.device(c1):
            y1 = torch.sin(x1) * 3.0 + 1.0
        back = torch.cuda.Event()
        back.record(s1)
        s0.wait_event(back)
        return y1

    def whole():
        y1 = card1_work()
        z = y1.to(c0, non_blocking=True)
        return torch.cos(x0) + z

    def eager_whole():
        return torch.cos(x0) + (torch.sin(x1) * 3.0 + 1.0).to(c0)

    # Each card's stream current on it (entering a stream makes its card
    # current), then card 0 current.
    with torch.cuda.stream(s1), torch.cuda.stream(s0), torch.cuda.device(c0):
        eager_whole()  # warm-up: kernels loaded, peer access enabled
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        pool = torch.cuda.graph_pool_handle()
        try:
            g, y1 = _capture(card1_work, pool)
            res["alloc"] = {"ok": True, "card1_segment_pool": _pool_of(y1),
                            "capture_pool": list(pool)}
            del g
        except BaseException as e:
            res["alloc"] = {"ok": False, "error": _error(e)}
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        graph = None
        try:
            graph, out = _capture(whole, torch.cuda.graph_pool_handle())
            res["peer_copy"] = {"ok": True}
        except BaseException as e:
            res["peer_copy"] = {"ok": False, "error": _error(e)}
        torch.cuda.synchronize(c0)
        torch.cuda.synchronize(c1)
        if graph is not None:
            try:
                x0.copy_(torch.rand(N, generator=gen).to(c0))
                x1.copy_(torch.rand(N, generator=gen).to(c1))
                torch.cuda.synchronize(c0)
                torch.cuda.synchronize(c1)
                graph.replay()
                torch.cuda.synchronize(c0)
                torch.cuda.synchronize(c1)
                want = eager_whole()
                torch.cuda.synchronize(c0)
                res["replay"] = {"ok": True, "bit_for_bit": bool(torch.equal(out, want)),
                                 "max_abs_err": float((out - want).abs().max().item()),
                                 "host_ms": _host_ms(graph.replay)}
            except BaseException as e:
                res["replay"] = {"ok": False, "error": _error(e)}
        else:
            res["replay"] = {"ok": False, "error": "no graph: the capture above failed"}

        # The engines' design: a graph a card, the copy between the replays.
        try:
            with torch.cuda.device(c1):
                g1, y1 = _capture(lambda: torch.sin(x1) * 3.0 + 1.0,
                                  torch.cuda.graph_pool_handle())
            recv = torch.empty(N, device=c0)
            g0, out0 = _capture(lambda: torch.cos(x0) + recv, torch.cuda.graph_pool_handle())

            def per_card():
                g1.replay()
                recv.copy_(y1, non_blocking=True)
                g0.replay()

            x0.copy_(torch.rand(N, generator=gen).to(c0))
            x1.copy_(torch.rand(N, generator=gen).to(c1))
            per_card()
            torch.cuda.synchronize(c0)
            torch.cuda.synchronize(c1)
            want = eager_whole()
            torch.cuda.synchronize(c0)
            res["per_card"] = {"ok": True, "bit_for_bit": bool(torch.equal(out0, want)),
                               "max_abs_err": float((out0 - want).abs().max().item()),
                               "card1_segment_pool": _pool_of(y1),
                               "host_ms": _host_ms(per_card),
                               "eager_host_ms": _host_ms(eager_whole)}
        except BaseException as e:
            res["per_card"] = {"ok": False, "error": _error(e)}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the result here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("cross_card_graph_probe: needs two CUDA cards", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"card": card, "cards": torch.cuda.device_count(), **probe()}
    line = json.dumps(res)
    print(line, flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
