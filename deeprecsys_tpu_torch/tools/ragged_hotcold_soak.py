"""Soak ragged ``/v1/predict`` on a hot/cold engine whose adaptive refresh
fires under drift, under sustained concurrent HTTP load.

    python -m deeprecsys_tpu_torch.tools.ragged_hotcold_soak [--minutes 15]
        [--phase-requests 300] [--min-requests 0] [--device cuda|cpu] [--out PATH]

Counterpart of ``tools/ragged_hotcold_soak.py:41-178``. Every request's
CSR lengths and values become a slot mask that the native splitter's
hash-index probe consumes, the refresh tracker counts valid slots only,
and each drift-triggered refresh builds a fresh ``HotIndex`` on the scan
worker and installs it mid-traffic. A leak, a race or a stale index shows
as an error response, a refresh that never comes, or RSS growth.

The stream: zipf(1.2) ids whose head rotates every ``--phase-requests``
requests (a per-phase offset mod each table's rows), so live coverage
collapses and the engine refreshes again and again; lengths uniform in
[0, L] per (row, table), empty groups included. The model: rm3 at
``--table-scale`` 100, hot/cold with a 16,384-row hot set, ``min_hit``
0.5, a refresh check every 24 executions over a window of 8. It serves on
the card (``engine_backend="gpu"``: K6 and the native splitter on the
serve thread) unless ``--device cpu`` is given.

``--min-requests N`` keeps the clients sending past ``--minutes`` until N
requests have been sent: a short run on a loaded host then still reaches
the refresh checks (the first one comes after 24 executions), where a time
bound alone may not.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.tools.common import (
    card_of, default_out, device_arg, max_rss_mb, write_record)
from deeprecsys_tpu_torch.utils.devices import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=15.0)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--phase-requests", type=int, default=300,
                    help="rotate the zipf head every N requests")
    ap.add_argument("--min-requests", type=int, default=0,
                    help="keep sending past --minutes until N requests were sent")
    ap.add_argument("--table-scale", type=int, default=100)
    ap.add_argument("--sample-s", type=float, default=30.0, help="progress line interval")
    device_arg(ap)
    ap.add_argument("--out", default=str(default_out("ragged_hotcold_soak")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_of(device)

    # The operating point makes the rotating head trigger refresh swaps,
    # not a disable: a 16k hot set's candidate coverage on this fold stays
    # above min_hit 0.5, and each rotation collapses live coverage.
    model_cfg = zoo.get_config("rm3", table_scale=args.table_scale).replace(
        embedding_impl="hotcold", hot_set_rows=16384, hotcold_min_hit=0.5)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    scfg = ServingConfig(engine_backend="gpu" if device.type == "cuda" else "cpu",
                         inference_engines=1, sub_task_batch_size=args.batch,
                         max_mini_batch_size=args.batch, batch_buckets=(args.batch,),
                         accept_ragged=True, hotcold_refresh_interval=24,
                         hotcold_refresh_window=8)
    server = ServingServer(model_cfg, scfg)
    ing = None
    try:
        server.start(timeout=900)
        ing = HttpIngress(server)
        ing.start()
    except BaseException:
        (ing or server).stop()
        raise
    base = "http://%s:%s" % ing.address

    def post(path, body, timeout=120):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())

    t_start = time.time()
    stop_at = t_start + args.minutes * 60
    lock = threading.Lock()
    stats = {"ok": 0, "errors": 0, "lat_ms": []}
    counter = [0]

    def client(cid: int):
        rng = np.random.default_rng(1000 + cid)
        while True:
            with lock:
                if time.time() >= stop_at and counter[0] >= args.min_requests:
                    break
                counter[0] += 1
                phase = counter[0] // args.phase_requests
            # The same skew, other head rows each phase: live coverage
            # collapses and the refresh fires.
            shift = (phase * 7919) % 100_000
            idx = (rng.zipf(1.2, size=(args.batch, T, L)) + shift) % rows[None, :, None]
            lengths = rng.integers(0, L + 1, size=(args.batch, T))
            values = np.concatenate(
                [idx[b, t, : lengths[b, t]] for b in range(args.batch) for t in range(T)]
                or [np.empty(0, np.int64)]).astype(np.int64)
            body = {"lengths": lengths.tolist(), "values": values.tolist()}
            if model_cfg.dense_dim:
                body["dense"] = rng.random((args.batch, model_cfg.dense_dim)).tolist()
            t0 = time.perf_counter()
            try:
                status, out = post("/v1/predict", body)
                ms = (time.perf_counter() - t0) * 1e3
                good = status == 200 and np.isfinite(np.asarray(out["scores"])).all()
                with lock:
                    stats["lat_ms"].append(ms)
                    stats["ok" if good else "errors"] += 1
            except Exception as e:  # noqa: BLE001 - the soak counts failures
                with lock:
                    stats["errors"] += 1
                print(f"[soak] client {cid} error: {e!r}", flush=True)

    rss0 = max_rss_mb()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(args.clients)]
    health, stop_err = {}, None
    try:
        for t in threads:
            t.start()
        while time.time() < stop_at:
            time.sleep(max(0.0, min(args.sample_s, stop_at - time.time())))
            with lock:
                n, e = stats["ok"], stats["errors"]
            print(f"[soak] t+{time.time() - t_start:.0f}s: {n} ok, {e} err, max rss "
                  f"{max_rss_mb():.0f} MB [{card}]", flush=True)
        for t in threads:
            t.join(timeout=180)
        with urllib.request.urlopen(base + "/v1/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        try:
            ing.stop()  # the listener and the server's engine
        except Exception as e:  # noqa: BLE001 - recorded as an unclean shutdown
            stop_err = repr(e)
    refreshes = sum(e.get("hot_refreshes", 0) or 0 for e in health.get("embedding_impl", []))
    lat = np.asarray(stats["lat_ms"])
    record = {
        "minutes": args.minutes, "clients": args.clients, "batch": args.batch,
        "phase_requests": args.phase_requests, "min_requests": args.min_requests,
        "table_scale": args.table_scale,
        "device": str(device), "card": card,
        "requests_ok": stats["ok"], "errors": stats["errors"], "hot_refreshes": refreshes,
        "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
        "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
        "rss_start_mb": rss0, "rss_end_mb": max_rss_mb(),
        "healthz": health, "clean_shutdown": stop_err is None,
    }
    if stop_err:
        record["shutdown_error"] = stop_err
    write_record(args.out, record)
    print(json.dumps({k: v for k, v in record.items() if k != "healthz"}), flush=True)
    return record


if __name__ == "__main__":
    main()
