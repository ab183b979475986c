"""cpu-mp payload soak: sustained ``/v1/predict`` traffic over the blob arena.

    python -m deeprecsys_tpu_torch.tools.cpu_mp_soak [--minutes 30] [--rate 8] [--accel]
        [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/cpu_mp_soak.py:37-260``. Two ``cpu-mp`` engine
processes (``serving/process_engine.py``: CPU engines by design) serve
fixed and ragged client payloads that cross the shared-memory arena, for
``--minutes``. Every ``--sample-s`` it samples the completed queries, the
tails, the parent's RSS and the arena's in-flight slot count, which must
return to zero whenever traffic pauses (a creep is leaked slots, a plateau
at the slot count exhaustion; both also show on ``/v1/healthz``). An
exhaustion cycle (first at ``--first-exhaustion-s``, then every
``--exhaustion-every-s``) stages every arena slot, expects fast 503s,
frees the slots and expects a 200 again.

``--accel``: the reference's topology, the offload engine in this process
on the card (``accel_device``; ``--device cpu`` puts it on the host), and
one more client sending ``/v1/infer`` queries on both sides of the
offload threshold, so both routers rejoin under load. The record then also
holds the offload engine's executions (warm-up included), which the K1
launches of this process must equal.

The record is rewritten after every sample (``"status": "running"``) and
at the end (``"done"``), at ``--out``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.tools.common import (
    card_of, default_out, device_arg, rss_mb, write_record)
from deeprecsys_tpu_torch.utils.devices import resolve_device

TABLE_SCALE = 2000


def _post(base: str, path: str, body: bytes, timeout: float) -> dict:
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def exhaustion_cycle(server: ServingServer, base: str, T: int, L: int) -> dict:
    """Stage every arena slot (as in-flight queries would), send predicts
    into the wall (each must fail fast with a retryable 503, never hang or
    500), then free the slots and check that a predict is answered again.
    Slots that clients' queries hold at first are taken as those queries
    free them, so that the arena is full of staged slots alone."""
    held, deadline = [], time.monotonic() + 60
    while len(held) < server._arena.n_slots and time.monotonic() < deadline:
        try:
            held.append(server._arena.alloc())
        except RuntimeError:  # full: wait for the clients' in-flight queries
            time.sleep(0.001)
    outcome = {"slots_staged": len(held), "n_503": 0, "n_other": 0, "recovered_200": False}
    body = json.dumps({"indices": np.zeros((1, T, L), dtype=np.int32).tolist()}).encode()
    for _ in range(3):
        try:
            _post(base, "/v1/predict", body, 60)
            outcome["n_other"] += 1  # a 200 here means no backpressure
        except urllib.error.HTTPError as e:
            outcome["n_503" if e.code == 503 else "n_other"] += 1
        except Exception:  # noqa: BLE001 - the soak counts failures
            outcome["n_other"] += 1
    for s in held:
        server._arena.free(s)
    try:
        outcome["recovered_200"] = len(_post(base, "/v1/predict", body, 120)["scores"]) == 1
    except Exception as e:  # noqa: BLE001
        outcome["recovery_error"] = repr(e)
    print(f"[cpu_mp_soak] exhaustion cycle: {outcome}", flush=True)
    return outcome


def _executions(engine) -> int:
    return sum(engine.bucket_counts.values()) + engine.warmup_executions


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--rate", type=float, default=8.0, help="per-client QPS")
    ap.add_argument("--model", default="ncf")
    ap.add_argument("--accel", action="store_true",
                    help="the offload engine in this process, on --device, and an "
                         "/v1/infer client whose big queries it takes")
    ap.add_argument("--sample-s", type=float, default=30.0)
    ap.add_argument("--first-exhaustion-s", type=float, default=120.0)
    ap.add_argument("--exhaustion-every-s", type=float, default=300.0)
    device_arg(ap)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)
    out_path = args.out or default_out("cpu_mp_soak_accel" if args.accel else "cpu_mp_soak")

    model_cfg = zoo.get_config(args.model, table_scale=TABLE_SCALE)
    accel_kw = {"model_accel": True, "accel_request_size_thres": 12} if args.accel else {}
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2, batch_buckets=(8, 16),
                        max_mini_batch_size=16, sub_task_batch_size=8, accept_ragged=True,
                        **accel_kw)
    server = ServingServer(model_cfg, cfg, accel_device=str(device))
    ing = None
    try:
        server.start(timeout=600)
        ing = HttpIngress(server)
        ing.start()
    except BaseException:
        (ing or server).stop()
        raise
    base = "http://%s:%s" % ing.address
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    stop = threading.Event()
    lock = threading.Lock()
    errors: list = []
    counts = {"ok": 0, "503": 0, "infer_accel": 0, "infer_child": 0}

    def failed(e) -> bool:
        with lock:
            errors.append(repr(e))
            return len(errors) > 50

    def client(seed: int):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            b = int(rng.integers(1, 13))
            payload = {"indices": rng.integers(0, rows[None, :, None],
                                               size=(b, T, L)).astype(np.int32).tolist()}
            if rng.random() < 0.3:  # ~30% ragged traffic over the arena
                payload["lengths"] = rng.integers(0, L + 1, size=(b, T)).tolist()
            try:
                out = _post(base, "/v1/predict", json.dumps(payload).encode(), 120)
                if len(out["scores"]) != b:
                    raise AssertionError(f"{len(out['scores'])} scores for {b} rows")
                with lock:
                    counts["ok"] += 1
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    # Expected during the exhaustion cycles: retryable
                    # backpressure, not a fault. Counted apart.
                    with lock:
                        counts["503"] += 1
                elif failed(e):
                    return
            except Exception as e:  # noqa: BLE001 - the soak counts failures
                if failed(e):
                    return
            stop.wait(rng.exponential(1.0 / args.rate))

    def infer_client(seed: int):
        """/v1/infer traffic on both sides of the offload threshold: big
        queries take the offload engine and its router, small ones the
        engine processes."""
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            big = bool(rng.integers(0, 2))
            size = int(rng.integers(13, 17)) if big else int(rng.integers(2, 12))
            try:
                out = _post(base, "/v1/infer", json.dumps({"batch_size": size}).encode(), 120)
                if out["accel"] != big:
                    raise AssertionError(f"a query of {size} rows routed accel={out['accel']}")
                with lock:
                    counts["infer_accel" if big else "infer_child"] += 1
            except Exception as e:  # noqa: BLE001
                if failed(e):
                    return
            stop.wait(rng.exponential(1.0 / args.rate))

    threads = [threading.Thread(target=client, daemon=True, args=(s,)) for s in range(3)]
    if args.accel:
        threads.append(threading.Thread(target=infer_client, daemon=True, args=(97,)))
    samples, exhaustions = [], []
    t0 = time.time()
    t_end = t0 + args.minutes * 60
    next_exhaustion = t0 + args.first_exhaustion_s
    head = {"model": args.model, "minutes": args.minutes, "device": str(device), "card": card}
    leaked = quiesce_health = None
    try:
        for t in threads:
            t.start()
        while time.time() < t_end:
            time.sleep(max(0.0, min(args.sample_s, t_end - time.time())))
            if time.time() >= next_exhaustion:
                exhaustions.append(exhaustion_cycle(server, base, T, L))
                next_exhaustion = time.time() + args.exhaustion_every_s
            st, h = _get(base, "/v1/stats"), _get(base, "/v1/healthz")
            with lock:
                ok = counts["ok"]
            samples.append({"t_s": round(time.time() - t0, 1), "predict_ok": ok,
                            "p50_ms": st.get("p50_ms"), "p95_ms": st.get("p95_ms"),
                            "slots_in_flight": h.get("payload_slots_in_flight"),
                            "rss_mb": rss_mb()})
            print(f"[cpu_mp_soak] {samples[-1]} [{card}]", flush=True)
            # A kill between samples still leaves the evidence on disk.
            write_record(out_path, {"status": "running", **head, "predict_ok": ok,
                                    "n_errors": len(errors), "samples": samples})
    finally:
        stop.set()
        for t in threads:
            # Outwait the clients' 120 s requests: a join that returns with
            # a request in flight would read its slot as a leak below.
            t.join(timeout=150)
        try:
            # Quiesced: every staged slot must have come back.
            leaked = server._arena.in_flight()
            quiesce_health = _get(base, "/v1/healthz")
            accel_executions = _executions(server.engines[0]) if args.accel else 0
        finally:
            ing.stop()  # the listener and the server's engines and processes
    rss = [s["rss_mb"] for s in samples] or [rss_mb()]
    half = max(len(rss) // 2, 1)
    if half == len(rss):  # one sample: no empty second half
        rss = rss * 2
    rec = {
        "status": "done", **head, "engines": cfg.inference_engines, "clients": len(threads),
        "predict_ok": counts["ok"], "n_errors": len(errors), "errors": errors[:10],
        "model_accel": args.accel, "infer_accel_ok": counts["infer_accel"],
        "infer_child_ok": counts["infer_child"], "accel_executions": accel_executions,
        "client_503s": counts["503"], "exhaustion_cycles": exhaustions,
        "slots_leaked_at_quiesce": leaked,
        "payload_slots_in_flight_at_quiesce": quiesce_health.get("payload_slots_in_flight"),
        "max_slots_in_flight": max((s["slots_in_flight"] or 0) for s in samples) if samples else 0,
        "rss_first_half_mb": float(np.mean(rss[:half])),
        "rss_second_half_mb": float(np.mean(rss[half:])),
        "samples": samples,
    }
    path = write_record(out_path, rec)
    print(f"[cpu_mp_soak] DONE: {counts['ok']} predicts, {len(errors)} errors, {leaked} slots "
          f"leaked, RSS {rec['rss_first_half_mb']:.1f} -> {rec['rss_second_half_mb']:.1f} MB "
          f"[{card}] -> {path}", flush=True)
    return rec


if __name__ == "__main__":
    main()
