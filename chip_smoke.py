#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeprecsys_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``deeprecsys_tpu_torch/ops/csrc/`` (one
``nvcc`` a source, all started together), checks K1, the pooled lookup, and
its int8 siblings K1-int8 (per-table scales, bit for bit) and K4 (row-wise
scales) at every zoo model's shape, on tables past 2^31 bytes too, and at
a small size where their designs could slip (K4's rows of each 16-byte
phase and tables that start on a 4-byte boundary or end their storage,
bags of 257 to 5000 rows of extreme values), and K3,
DIEN's RNN scan, at DIEN's shape against their plain PyTorch versions, and
checks all eight zoo models, with float and with int8 tables, against the
JAX package's outputs stored in ``tests/golden/torch_port_{rm1,zoo,quant}.npz``.
Before the fixtures (phase 3, widths) it holds every kernel at widths the
zoo does not use to its plain version with the same tolerances, at a small
size: K1, K1b, K1-int8, K4, K5 and the three K6 modes at d 4, 8, 12, 16
and 128 (the 16-byte-lane instances and the general ones), K5 also at
d 24, 48 and 100, each window mode at d = 8 (K5's window in both of its
plans, its bf16 shard also on rows of many adds, which its once-rounded
bound holds; K6 on a shard with the hits and on the cold-only route), K3
and K3b at H 4, 8 and 32; drives the dryrun's "dot"
DLRM (d = 8) and dien at H = 8 on the card against their CPU forwards,
each read around itself; and times K1 at rm1's shape with d = 8 and K3 at
DIEN's with H = 8 beside their plain versions, bounds and library calls.
Then it drives the models at full width (bf16, batch 512):

- rm1 through ``get_model(...).apply`` and the standalone CLI loop, timed
  against the plain path;
- the engines' CUDA graphs (phase 6): an rm1 engine with float, per-table
  int8 and row-wise int8 tables, a dien engine and an rm1 hot/cold engine
  at the canonical ladder, ragged requests accepted, each program's first
  replay (every bucket, masked twin and cold rung) held to ``model.apply``
  on the rows it was warmed on, with the graphs captured, their ms and
  their pool;
- rm1 through the serving stack (``serving.run_serving``: load generator,
  engines on their own CUDA streams replaying their graphs, aggregator) at
  the canonical DeepRecSys point, with 1 and with 4 engines, each engine's
  programs held as above; ``engine_bench``'s closed loop with 1 and 4
  engines, its window traced for the device's idle share; payload requests
  through an engine, held against ``model.apply``; a short DeepRecSched
  tuning run; and dien served through ``main.py --queue`` (K1 and K3);
- rm2, rm3, wnd, mtwnd, ncf, din and dien through ``get_model(...).apply``,
  three forwards each, checked against the plain path and timed, each
  model's table freed before the next; dien also through the CLI loop;
- with int8 tables (phase 12): rm1 in both modes through
  ``get_model(...).apply``, ``main.py --table_quant`` and ``run_serving``
  (one engine), timed; the other seven in ``int8_rowwise``, three forwards
  each checked against the plain path.

Then hot/cold serving (phase 13): K6, the hot/cold lookup, in the three
table layouts at rm1's, rm2's and din's full shapes on zipf(1.2) ids with
the JAX package's hot-set rule (masked and not; at rm1 also every id hot,
none hot and an empty hot set), held to its plain version and to the direct
kernel on the same ids, and its first launch's ``cold_start`` held to
``torch.searchsorted`` of the cold stream; rm1 served through ``run_serving`` with
``embedding_impl="hotcold"`` (every served execution split by the native
splitter), a refreshing engine on zipf payloads that must upgrade its hot
set while its scores match the direct model, ``"auto"`` choosing the direct
lookup on the uniform stream, and ``main.py --queue --embedding_impl
hotcold`` with both int8 layouts; then K6's times and
``experiments/skew_bench.py``'s direct-against-split measurement for rm1,
rm2 and din.

Then the serving fabric (phase 14, after phase 7, on phase 5's rm1): the
HTTP ingress (``serving/ingress.py``) on one engine, with ``/v1/infer`` and
``/v1/predict`` at canonical sizes timed beside the same queries
in-process, phase 5's batch and a ragged batch (lengths + values) through
``/v1/predict`` held to the direct (masked) forward, and the health, stats
and metrics routes; a checkpoint of other params swapped in by ``POST
/v1/reload`` while two clients keep sending (0 failed requests, then the
new params' scores), for the direct engine and a hot/cold one (K6 goes on
after the swap); ``run_serving`` with two cpu-mp engine processes (CPU,
``FABRIC_MP_SCALE``) and the offload engine on the card; and ``main.py
--checkpoint --score_output``.

Each kernel is timed beside its plain version, its bound and one PyTorch
call computing the same function (``F.embedding_bag`` at every zoo shape,
cuDNN's tanh RNN at DIEN's), from ``deeprecsys_tpu_torch/kernel_bench.py``.

Then the trainer (phase 11): the training kernels K1b (the lookup's
backward), K5 (sparse row-wise AdaGrad) and K3b (the RNN's reverse scan)
against their plain versions at rm1's and DIEN's training shapes (batch 128,
full-size tables) in f32 and bf16, K5 also on heavily repeated rows; K10
(the optimizer update) bit for bit against its plain version for sgd,
adagrad and adam in f32 and bf16, on odd and unaligned leaves and on rm1's
full-size params; the JAX trainer's losses in
``tests/golden/torch_port_train.npz`` reproduced on the card;
``deeprecsys_tpu_torch.train.main`` at full width (f32, the CLI's dtype)
for rm1 dense, rm1 ``--sparse_tables`` and dien ``--sparse_tables``,
``TRAIN_STEPS`` steps each, the launches read around each run; the save ->
export -> ``main.py --checkpoint`` (standalone and ``--queue``) round trip
at ``--table_scale 100`` (the file format does not depend on the table's
size, and a 4 GB ``.npz`` a run is not worth the time), and the trainer's
``int8_rowwise`` and ``int8`` exports served through ``main.py --checkpoint
--table_quant`` (standalone and ``--queue``); the four kernels' times (K10
over rm1's dense params); then, for rm1 dense (adagrad and adam), rm1
``--sparse_tables`` and dien ``--sparse_tables``, two arms from the same
weights on the same batches: the trainer's programs (``Trainer.step``: a
shape's first step eager, then captured as a CUDA graph, every later step
a replay) and its step function called eagerly; ``GRAPH_STEPS`` steps of
each held together within the ``GRAPH_*`` limits, with equal launches and
no kernel wrapper called from Python over the replays, then each arm's
step wall, device time and idle share, the captures, capture ms, graph
pool bytes and peak memory. Since adam's count lives on the card, K10 is
held to its plain version at counts 1, 2 and 1000.

Then the data modes and the experiments (phase 15), each path read around
itself: rm1 standalone on stack-distance trace ids (``data/trace.py``'s
``sd_cumm`` of a zipf stream, ``--data_generation synthetic``) with K1 held
to its plain version on them and timed beside phase 7's uniform ids;
``--model criteo --data_generation dataset --score_output`` on a Criteo TSV
(26 tables x 1 M x 32), one score a file row, K1 at L = 1 held to its
plain version; rm1's latency ladder swept on the card
(``experiments/sweep.py``) into a temporary ``gpu_rm1.json`` and
``--queue --engine_backend sim`` over it at the canonical point, its p95
beside phase 6's real engine; ``--enable_profiling`` (its trace lists K1)
and ``experiments/op_breakdown.py`` for rm1 and dien; ``train_planted``
(``experiments/train_quality.py``, sparse tables) on rm1 at full size with
its holdout AUC beside the Bayes ceiling, and that model's int8 row-wise
export checkpointed and served through ``ServingServer`` on the card
within 0.02 AUC of it (the JAX lifecycle test's rule); and
``experiments/qps_sweep.py`` on the card for rm1's latency-bounded QPS.

Then serving over meshes (phase 16, after phase 14): the window kernels at
rm1's and rm2's shards, rm1's ``sharded_apply``, its int8, table-wise and
hot/cold layouts, payloads, ``run_serving`` and a refreshing hot/cold engine
on meshes whose entries all name the card (virtual shards), each engine's
programs one CUDA graph each; and, where the machine has two cards or more,
rm1 through ``run_serving`` on 2x2, 1x4 and 1x2 meshes of distinct cards (as
many as it holds), each program a graph a card's part, beside the same
engine with its programs eager and the same mesh of card 0's virtual
shards, their QPS and p95 on lines of their own (on one card a line says
that this part did not run).

Then training over meshes whose entries all name the card (phase 17, after
phase 11; virtual shards: every launch, gradient reduction and update runs,
no scaling across cards shows): rm1 at full size (f32, batch 128) trained
dense (adagrad) on 1x4 and 2x2 and sparse on 1x4, 2x2 and 4x1, a 2x2
``dedup=True`` step, and dien sparse on 1x4, each from the single-device
trainer's weights on its batches: the losses of three steps against the
single-device trainer's; after one step the mesh's pooled gradients within
1e-5 of their max |g| of the single-device ones, and the table and
accumulator within the bounds of the steps' kernels plus what that limit
carries; every launch of K1's, K1b's and K5's ownership windows in step 1,
and the single-device step's K5, against its plain version; and the
launches around each path (K1's window D*M a step, K1b's window D*M a dense
step, K5's window M a sparse step, K10 once);
``make_train_step`` on the dryrun's "dot" DLRM (four SGD steps on one
batch, the loss falling, step 1's windows against their plain versions)
and on rm1 for one step against the single-device SGD step; the two
windows' times at rm1's 1/4 shard beside their bounds, plain versions and
``index_add_`` yardsticks; each path's step times in phase 11's two arms
(its programs, replayed CUDA graphs on a mesh of one card, and its step
function called eagerly, held together as there; rm1 with bf16 params on
1x4 and 2x2 too, K5's bf16 window inside the graph, its launches on an
eager step against its plain version, and over several cards); K5's bf16
window captured alone and replayed against its plain version, its replay
span timed; and ``dedup=True`` against ``False`` for rm1's and rm2's
single-device sparse steps (each step's K5 then, on an eager step,
against its plain version), with the sort and segment sum alone.

Then a mesh across processes (phase 18, after phase 17): two spawned
processes share the card over gloo (NCCL refuses two ranks on one card),
each holding two entries of a mesh that ``make_mesh`` gathers from both:
rm1 at full size through ``sharded_apply`` in bf16 at batch 512 on 2x2
(each process a data row) and 1x4 (the sum over "model" crosses the
processes) against the single-device forward, and the dense and sparse
f32 steps at batch 128 on 1x4, two each, whose losses are held to the
single-process mesh trainer's; every launch of K1's, K1b's and K5's
windows in the children against its plain version, the children's
launches counted in the kernels line, and the walls of ten forwards and
steps by CUDA events in each child (two processes on one card, the
collectives through the host: they show no scaling). With two cards or
more, processes of a card each over nccl (two on 1x2, four on 2x2 and
1x4): rm1's dense, sparse and bf16 sparse steps, each trainer built
eager (its graphs replay slower, ``train_programs.NCCL_SLOWER``) and then
made to take its programs, a CUDA graph a process holding its
collectives, against the step function called eagerly, with the walls of
both timed in turns, the collectives a step and the graphs' captures and
pools; with fewer cards a line says the part did not run.

Then the port's tools (phase 19, last), each run briefly from its
``main(argv)`` (``deeprecsys_tpu_torch/tools/``) and read back from its
record under ``chiprun_out/tools/``: ``cpu_mp_soak --accel`` (two cpu-mp
engine processes over the blob arena and the offload engine on the card
under sustained HTTP load, one arena exhaustion cycle: 0 errors, 503s at
the wall and a recovered 200, 0 slots leaked, K1's launches the offload
engine's executions); ``ragged_hotcold_soak`` (ragged predicts on an rm3
hot/cold engine on the card whose refresh fires under a rotating zipf
head: 0 errors, at least two refreshes, K6 launched and its plain version
never called by the path); ``mesh_bench`` on 1x4 and 2x2 meshes of the
card (rm1 full size; virtual shards, so labelled: K1's window D*M times a
forward, the splitter's descriptor counters within the JAX test's law);
``sim_revalidate`` (rm1 served on the card and simulated over its ladder
at the JAX sim-validation point; the sim launches nothing); and
``refresh_scan_cost`` (rm1's refresh scan on the host). The first launches
of each kernel on these paths are held to their plain versions.

Phases run in order and any failure raises, so the script exits non-zero
and never prints the closing line. Without a CUDA card it exits non-zero
at once. It imports no JAX and nothing of the JAX package: only
``deeprecsys_tpu_torch``.

The last three lines are the card's ``name, power.limit`` as nvidia-smi
gives them, ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing as mp
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from deeprecsys_tpu_torch import ModelConfig, ServingConfig, bridge, zoo
from deeprecsys_tpu_torch import main as port_main
from deeprecsys_tpu_torch import train as port_train
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.data import trace as trace_mod
from deeprecsys_tpu_torch.data.ragged import pad_csr
from deeprecsys_tpu_torch.engine_bench import engine_arm
from deeprecsys_tpu_torch.experiments.skew_bench import _hot_set, measure_skewed, zipf_stream
from deeprecsys_tpu_torch.experiments.skew_bench import line as skew_line
from deeprecsys_tpu_torch.experiments import op_breakdown, qps_sweep, train_quality
from deeprecsys_tpu_torch.experiments.nccl_step_probe import turn_walls
from deeprecsys_tpu_torch.experiments import sweep as sweep_mod
from deeprecsys_tpu_torch.kernel_bench import (
    HBM_BYTES_PER_S, cold_starts_bound, direct_call, g_rows, hotcold_calls, hotcold_inputs,
    k1_bound, k1_int8_bound, k1_library, k1b_bound, k1b_library, k3_bound, k3_library, k3b_bound,
    k3b_library, k4_bound, k5_bound, k5_library, k6_bound, k6_call, k6_cold_bound, k10_bound,
    k10_inputs, k10_library, k1b_window_bound, k5_window_bound, mean_bound, measure,
    named_kernel_ms, ptxas_summary,
    random_int8_tables, span_ms, wall_ms, window_bound, window_g_rows, window_library)
from deeprecsys_tpu_torch.models import get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import Batch, table_offsets
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for, make_hotcold_model
from deeprecsys_tpu_torch.ops import (
    _build, embedding_bag, embedding_bag_backward, embedding_bag_backward_reference,
    embedding_bag_backward_shard, embedding_bag_cold_partial_reference, embedding_bag_hotcold,
    embedding_bag_hotcold_int8, embedding_bag_hotcold_int8_reference,
    embedding_bag_hotcold_int8_rowwise, embedding_bag_hotcold_int8_rowwise_reference,
    embedding_bag_hotcold_int8_rowwise_shard, embedding_bag_hotcold_int8_shard,
    embedding_bag_hotcold_reference, embedding_bag_hotcold_shard, embedding_bag_int8,
    embedding_bag_int8_reference, embedding_bag_int8_rowwise,
    embedding_bag_int8_rowwise_reference, embedding_bag_int8_rowwise_shard,
    embedding_bag_int8_shard, embedding_bag_reference, embedding_bag_shard,
    optimizer_update, optimizer_update_reference, rnn_scan, rnn_scan_backward,
    rnn_scan_backward_reference, rnn_scan_reference, sparse_adagrad_step,
    sparse_adagrad_step_reference, sparse_adagrad_step_shard)
from deeprecsys_tpu_torch import ops as port_ops
from deeprecsys_tpu_torch.ops import embedding as emb_mod
from deeprecsys_tpu_torch.ops import hotcold as hotcold_ops
from deeprecsys_tpu_torch.ops.embedding import (
    backward_tolerance, cold_tolerance, hotcold_cold_starts, hotcold_tolerance, pooled_tolerance,
    rowwise_tolerance, scatter_counts, table_range, window_ids)
from deeprecsys_tpu_torch.ops.rnn import KERNEL_HIDDEN, rnn_scan_tolerance
from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_tolerance
from deeprecsys_tpu_torch.train_programs import NCCL_SLOWER
from deeprecsys_tpu_torch.parallel import (
    distributed_init, make_mesh, make_train_step, shard_params, sharded_apply)
from deeprecsys_tpu_torch.parallel.sharding import leaf_copies, leaf_groups
from deeprecsys_tpu_torch.parallel.api import make_tablewise_model
from deeprecsys_tpu_torch.runtime.native import native_available
from deeprecsys_tpu_torch.serving import ServiceRequest, latency_model, orchestrator, run_serving
from deeprecsys_tpu_torch.serving.buckets import resolve_buckets
from deeprecsys_tpu_torch.serving.engine import ComputeEngine, build_engine_pool
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.serving.load_generator import model_batch_sizes
from deeprecsys_tpu_torch.serving.packets import ERR_OK, ERR_PAYLOAD
from deeprecsys_tpu_torch.utils.checkpoint import (
    checkpoint_params, load_model_params, save_params)
from deeprecsys_tpu_torch.tools import cpu_mp_soak as tool_soak
from deeprecsys_tpu_torch.tools import mesh_bench as tool_mesh
from deeprecsys_tpu_torch.tools import ragged_hotcold_soak as tool_ragged
from deeprecsys_tpu_torch.tools import refresh_scan_cost as tool_scan
from deeprecsys_tpu_torch.tools import sim_revalidate as tool_sim
from deeprecsys_tpu_torch.utils.devices import synchronize

ROOT = Path(__file__).resolve().parent

FIXTURE = ROOT / "tests" / "golden" / "torch_port_rm1.npz"
ZOO_FIXTURE = ROOT / "tests" / "golden" / "torch_port_zoo.npz"
# The kernels, with the JAX op each replaces. K1's op is the fused gather +
# sum (its XLA gather is at :794; the Pallas kernels that computed it were
# removed in commit 5ad96f1); K3's is the scan of basic_rnn_scan.
KERNELS = {
    "embedding_bag": {"source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag.cu",
                      "replaces": "deeprecsys_tpu/ops/embedding.py:770"},
    "rnn_scan": {"source": "deeprecsys_tpu_torch/ops/csrc/rnn_scan.cu",
                 "replaces": "deeprecsys_tpu/ops/rnn.py:45"},
    # The trainer's: the gather's VJP under jax.value_and_grad (train.py:361),
    # the sparse table step's scatters, and the scan's VJP.
    "embedding_bag_backward": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_backward.cu",
        "replaces": "deeprecsys_tpu/ops/embedding.py:770"},
    "sparse_adagrad_step": {"source": "deeprecsys_tpu_torch/ops/csrc/sparse_adagrad.cu",
                            "replaces": "deeprecsys_tpu/train.py:258"},
    "rnn_scan_backward": {"source": "deeprecsys_tpu_torch/ops/csrc/rnn_scan_backward.cu",
                          "replaces": "deeprecsys_tpu/ops/rnn.py:45"},
    # K10: optax's update and apply_updates in the jitted dense step
    # (train.py:362-363) and in the sparse step's dense half (:255-256).
    "optimizer_update": {"source": "deeprecsys_tpu_torch/ops/csrc/optimizer_update.cu",
                         "replaces": "deeprecsys_tpu/train.py:362"},
    # The int8 lookups (one source): K1-int8 the per-table pool (XLA, in
    # pooled_lookup), K4 embedding_bag_int8_rowwise.
    "embedding_bag_int8": {"source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_int8.cu",
                           "replaces": "deeprecsys_tpu/models/base.py:178"},
    "embedding_bag_int8_rowwise": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_int8.cu",
        "replaces": "deeprecsys_tpu/ops/embedding.py:262"},
    # K6, the hot/cold lookup (one source): the XLA op of
    # _embedding_bag_hotcold_impl behind each of the three entry points.
    "embedding_bag_hotcold": {"source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
                              "replaces": "deeprecsys_tpu/ops/embedding.py:542"},
    "embedding_bag_hotcold_int8": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
        "replaces": "deeprecsys_tpu/ops/embedding.py:737"},
    "embedding_bag_hotcold_int8_rowwise": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
        "replaces": "deeprecsys_tpu/ops/embedding.py:759"},
    # Phase 16, the mesh modes of the same sources: K1, K1-int8 and K4 with
    # the ownership window (a row shard's masked gather and pool under the
    # TPU package's shard_map, and the int8 pools GSPMD partitions in its
    # sharded_apply), and K6 on a shard's cold stream (the shard_map bodies
    # of its sharded and hybrid hot/cold lookups: with the hot hits on the
    # first shard, on the cold-only route on the others, both counted here),
    # each leaving the partial in the type it sums in.
    "embedding_bag_shard": {"source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag.cu",
                            "replaces": "deeprecsys_tpu/parallel/sharding.py:118"},
    "embedding_bag_int8_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_int8.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:411"},
    "embedding_bag_int8_rowwise_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_int8.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:411"},
    "embedding_bag_hotcold_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:172"},
    "embedding_bag_hotcold_int8_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:172"},
    "embedding_bag_hotcold_int8_rowwise_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_hotcold.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:228"},
    # Phase 17, the training windows: K1b's (the VJP of a row shard's
    # masked gather and pool under the dense mesh step's value_and_grad)
    # and K5's (the sharded sparse step's masked scatters).
    "embedding_bag_backward_shard": {
        "source": "deeprecsys_tpu_torch/ops/csrc/embedding_bag_backward.cu",
        "replaces": "deeprecsys_tpu/parallel/sharding.py:118"},
    "sparse_adagrad_step_shard": {"source": "deeprecsys_tpu_torch/ops/csrc/sparse_adagrad.cu",
                                  "replaces": "deeprecsys_tpu/train.py:177"},
}
# The lookup kernel each table layout takes (cfg.table_quant).
LOOKUP = {"none": "embedding_bag", "int8": "embedding_bag_int8",
          "int8_rowwise": "embedding_bag_int8_rowwise"}
QUANT_MODES = ("int8", "int8_rowwise")
# The hot/cold lookup kernel each table layout takes.
HOTCOLD = {"none": "embedding_bag_hotcold", "int8": "embedding_bag_hotcold_int8",
           "int8_rowwise": "embedding_bag_hotcold_int8_rowwise"}
HOTCOLD_MODELS = ("rm1", "rm2", "din")  # K6's cases and the skew measurement
HOTCOLD_QUERIES = 200
HOTCOLD_CLI_QUERIES = 50
# Zipf payload requests (64 rows each) through the refreshing engine: it
# scans every REFRESH_INTERVAL executions; the upgrade lands a few later.
REFRESH_INTERVAL = 4
REFRESH_MAX_PAYLOADS = 48
# The refreshing engine's hot_set_rows (0: suggest_hot_rows, 131,072 rows).
# A CPU rehearsal at TABLE_SCALE 2000, where that covers rm1's whole table,
# sets it below the table.
REFRESH_HOT_ROWS = 0
QUANT_FIXTURE = ROOT / "tests" / "golden" / "torch_port_quant.npz"
ZOO = ("rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")
TIMED_ITERS = 100
# Port vs the JAX fixtures. rm1: f32 as the golden outputs; bf16 one bf16
# ulp of a sigmoid score in [0.5, 1), as tests/test_torch_dlrm.py holds it.
# The other models: f32 rtol and atol 1e-5, bf16 two bf16 ulps of the
# output's largest magnitude (bf16_atol), as tests/test_torch_models.py.
F32_RTOL = 1e-5
F32_ATOL = 1e-5
BF16_ATOL = 2.0 ** -8
# K3 against its plain loop, run free over all T steps (each step also
# held, teacher-forced, to rnn_scan_tolerance): two f32 summation orders
# of the recurrent dot drift apart by ~1e-6 over 40 steps in f32 and by
# one bf16 ulp (2^-8 for |h| in [0.5, 1)) in bf16, measured on the CPU;
# the bounds leave a factor of ~10 and 2.
K3_F32_ATOL = 1e-5
K3_BF16_ATOL = 2.0 ** -7
# K3 at DIEN's shape is checked on inputs from this many seeds, so that the
# margin under K3_BF16_ATOL is read on more than one draw.
K3_SEEDS = 4
BATCH = 512
# Full-size tables; a CPU rehearsal of the forward phases sets it larger.
TABLE_SCALE = 1
DIEN_T = 40  # dien's behaviour tables: the scan length
# The canonical DeepRecSys serving point (BASELINE.md): query sizes
# ~N(165, 16) capped at 1024, sub-batches of 32, Poisson arrivals 10 ms
# apart on average.
SERVING_POINT = {"batch_size_distribution": "normal", "avg_mini_batch_size": 165,
                 "var_mini_batch_size": 16, "max_mini_batch_size": 1024,
                 "sub_task_batch_size": 32, "avg_arrival_rate_ms": 10.0}
SERVE_QUERIES = 200
DIEN_QUERIES = 50
# Phase 6, the engines' CUDA graphs: an engine of each of these (model,
# tables, lookup) at the canonical ladder, ragged requests accepted (so its
# masked twins too), the hot/cold one tracking refreshes (so its direct
# programs too), each program's first replay held to the eager forward; and
# engine_bench's closed loop with 1 and 4 engines, its window traced.
PROGRAM_ENGINES = (("rm1", "none", "xla"), ("rm1", "int8", "xla"),
                   ("rm1", "int8_rowwise", "xla"), ("dien", "none", "xla"),
                   ("rm1", "none", "hotcold"))
PROGRAM_HOT_ROWS = 4096  # the hot/cold engine's set: its sample stays 8 batches
CAPACITY_EXECUTIONS = 1000
CAPACITY_ROWS = 32
TRAIN_FIXTURE = ROOT / "tests" / "golden" / "torch_port_train.npz"
TRAIN_FAMILIES = ("rm1", "wnd", "mtwnd", "ncf", "din", "dien")
TRAIN_BATCH = 128  # the train CLI's default batch
TRAIN_STEPS = 60
ROUND_TRIP_SCALE = 100
# The card's losses against the JAX trainer's (CPU, XLA) on the fixture's
# batches: f32 sums in other orders (cuBLAS, K1b's and K5's atomics) over
# three steps (measured at most 3.5e-7 on an H100, PERF.md), with a margin.
TRAIN_LOSS_RTOL = 1e-4
# The trainer's programs (CUDA graphs) against its step functions called
# eagerly, phases 11 and 17: the runs (model, sparse tables, optimizer) at
# full width, f32, batch TRAIN_BATCH; GRAPH_STEPS steps of each arm from the
# same weights on the same batches, then TRAIN_TIMED steps of each timed
# (after a warm-up step a batch). The arms differ only in the order of K1b's
# and K5's atomic adds, so they are held to tests/test_torch_train.py's
# limits between the port and JAX: losses rtol 1e-5; params rtol 1e-5 and
# atol 1e-6, adam's atol 2% of the steps' reach (lr x steps: its update
# turns the rounding of a near-zero gradient into an O(lr) change), a
# sparse table's 1e-3 of it (the row-wise scale multiplies the gradients'
# rounding); row accumulators 1e-4 of the largest. The learning rates are
# that file's, below the CLI's 0.1, where the bce clip could take a score's
# gradient away in one arm and not the other.
GRAPH_RUNS = (("rm1", False, "adagrad"), ("rm1", True, "adagrad"), ("dien", True, "adagrad"),
              ("rm1", False, "adam"))
GRAPH_STEPS = 4
TRAIN_TIMED = 20
GRAPH_LR = {"sgd": 0.05, "adagrad": 0.01, "adam": 1e-3}
GRAPH_LOSS_RTOL = 1e-5
GRAPH_PARAM_RTOL = 1e-5
GRAPH_PARAM_ATOL = 1e-6
GRAPH_ADAM_REACH = 0.02
GRAPH_SPARSE_REACH = 1e-3
GRAPH_ACC_RTOL = 1e-4
# A bf16 table's sparse mesh step (phase 17's "sparse bf16" paths, phase
# 18's over nccl): K5's bf16 window sums a row's updates in f32 in the order
# its atomic adds take, then rounds the row once, so a bf16 value may land a
# bf16 ulp from the other arm's. bf16 params are held within
# GRAPH_BF16_RTOL of each value (two bf16 ulps) beside the atols above, the
# losses within GRAPH_BF16_LOSS_RTOL.
GRAPH_BF16_RTOL = 2.0 ** -7
GRAPH_BF16_LOSS_RTOL = 1e-3
# The spin a graphed step's device span is queued behind (GPU cycles, ~1 ms
# on an H100): longer than the host's work to queue a step.
GRAPH_SPIN_CYCLES = 2_000_000
# K3b against its plain loop in f32: two orders of the 64-term dot carried
# over the scan's steps, within this share of the largest |delta|.
K3B_RTOL = 1e-5
# K5's heavy-duplicate cases: the generator's ids folded onto this many rows
# a table (rm1: each row ~20 adds a step; dien: ~2).
DUP_ROWS = 64
# K10's small leaves (elements), beside an unaligned slice of each size
# and rm1's full-size params: one element, a size under one 16-byte vector,
# sizes past a vector and past the kernel's 65,536-element chunks.
K10_SIZES = (1, 3, 4097, 2 * 65536 + 5)
# The step counts of those K10 checks: adam's bias corrections at counts 1 and 2 and
# far into a run (the kernel's powf against torch.pow on the card).
K10_COUNTS = (1, 2, 1000)
# The int8 bundles' scores against those of the float checkpoint they were
# exported from (rm1, sigmoid scores in [0, 1]): the rounding of each table
# value to 7 bits, pooled over 80 rows and carried through the towers.
# Measured 9.9e-5 (int8) and 8.0e-5 (int8_rowwise) on the CPU for this
# phase's run (table_scale 100, 20 steps); tests/test_torch_quant.py holds
# the same bound at table_scale 2000.
QUANT_SCORE_ATOL = 5e-3
# Phase 14, the serving fabric: timed queries of each kind (HTTP and
# in-process, sizes ~N(165, 16)), the clients that keep sending through a
# reload, and the cpu-mp run: its engine processes build their own CPU
# tables, so it runs at FABRIC_MP_SCALE; queries of FABRIC_ACCEL_THRES rows
# and more (~27% of N(165, 16)) go whole to the offload engine on the card.
FABRIC_QUERIES = 30
FABRIC_CLIENTS = 2
FABRIC_MP_SCALE = 10
FABRIC_MP_QUERIES = 100
FABRIC_ACCEL_THRES = 175
# Phase 15, the data modes and the experiments: the stack-distance
# distribution profiled from a zipf stream (its profile is quadratic in the
# stack, so a few ten thousand samples), the standalone runs' batches, the
# Criteo file's rows (whole batches: one score a row), op_breakdown's
# batches, train_planted at the JAX defaults (600 steps of 512, lr 0.01,
# table_lr 1e-3), and qps_sweep's arrival rates (ms) on one engine at the
# JAX CLI's sub-batch.
TRACE_LINES = 20_000
TRACE_SAMPLES = 20_000
TRACE_ALPHA = 1.05
DATA_BATCHES = 4
CRITEO_ROWS = 4096
OP_BATCHES = (1, 16, 256)
QUALITY_STEPS = 600
QUALITY_BATCH = 512
QPS_SLA_MS = 25.0
QPS_ARRIVALS = (4.0, 2.0, 1.4, 1.0)
QPS_QUERIES = 300
QPS_SUB_BATCH = 256
# The served int8 export's holdout AUC against the trained model's: the
# JAX lifecycle test's limit (tests/test_train_quality.py:68).
SERVED_AUC_TOL = 0.02
# Phase 16, serving over meshes whose entries all name the card (virtual
# shards): the row shards of the kernels' cases and of the 1xM meshes, the
# meshes rm1 runs on, and the models whose 1/4-shard windows are checked.
MESH_SHARDS = 4
MESH_AXES = ((1, 4), (2, 2), (4, 1))
K6_TIMED_BATCHES = 4  # K6 on a shard timed on the zipf batches after the hot set's warm-up
MESH_KERNEL_MODELS = ("rm1", "rm2")
# Phase 16's served rm1 engine: one engine over each of these meshes of the
# card at the canonical point, its programs captured; beside it the eager
# 2x2 engine, measured before mesh engines captured their programs (PERF.md
# section 5, an NVIDIA H100 80GB HBM3 at 700 W).
MESH_SERVING_AXES = ((2, 2), (1, 4))
MESH_EAGER_2X2 = {"measured_qps": 62.49, "p95_ms": 1199.649}
# Phase 16's engines over several cards: one rm1 engine over each of these
# meshes of distinct cards that the machine holds, graphed, beside the same
# engine with its programs eager and the same mesh of card 0's virtual
# shards, each at the canonical point.
MESH_CARDS_AXES = ((2, 2), (1, 4), (1, 2))
# The window kernel and K6's shard mode of each table layout.
SHARD = {"none": "embedding_bag_shard", "int8": "embedding_bag_int8_shard",
         "int8_rowwise": "embedding_bag_int8_rowwise_shard"}
# Phase 17, training over meshes of the card at rm1's full size: the paths
# held to the single-device trainer (mode, data, model axes; "dedup" is
# sparse with dedup=True), the steps of that check, the CLI's learning
# rate, the timed paths (in phase 11's two arms), make_train_step's steps on the
# dryrun's tiny "dot" DLRM (__graft_entry__.py:56-63), and the models of the
# dedup measurement.
MESH_TRAIN_RUNS = (("dense", 1, 4), ("dense", 2, 2), ("sparse", 1, 4), ("sparse", 2, 2),
                   ("sparse", 4, 1), ("dedup", 2, 2))
MESH_PARITY_STEPS = 3
MESH_G_RTOL = 1e-5  # the mesh's pooled gradients against one device's, of their max |g|
MESH_TRAIN_LR = 0.1
MESH_TIMED_RUNS = (("rm1", "dense", (1, 4)), ("rm1", "dense", (2, 2)), ("rm1", "sparse", (1, 4)),
                   ("rm1", "sparse", (2, 2)), ("rm1", "sparse", (4, 1)), ("rm1", "dedup", (2, 2)),
                   ("rm1", "make_train_step", (2, 2)), ("dien", "sparse", (1, 4)),
                   ("rm1", "sparse bf16", (1, 4)), ("rm1", "sparse bf16", (2, 2)))
# Phase 17's part over several cards (two cards or more): the paths (model,
# mode, mesh of distinct cards) in three arms from the same weights on the
# same batches, graphed over the cards, eager over the cards, graphed on card
# 0's virtual shards of the same mesh; the graphed and eager arms held
# together by the GRAPH_* limits over GRAPH_STEPS steps, the one-card arm's
# losses to the graphed arm's by GRAPH_LOSS_RTOL; then TRAIN_TIMED steps of
# each timed.
MESH_TRAIN_CARDS = (("rm1", "dense", (2, 2)), ("rm1", "dense", (1, 4)), ("rm1", "dense", (1, 2)),
                    ("rm1", "sparse", (2, 2)), ("rm1", "sparse", (1, 4)),
                    ("rm1", "sparse", (1, 2)), ("rm1", "dedup", (2, 2)),
                    ("dien", "sparse", (1, 4)), ("rm1", "make_train_step", (2, 2)),
                    ("rm1", "sparse bf16", (2, 2)), ("rm1", "sparse bf16", (1, 4)))
DRYRUN_STEPS = 4
DRYRUN_CFG = dict(model_type="dlrm", model_name="dryrun", mlp_bot=(16, 8), mlp_top=(16, 8, 1),
                  embedding_rows=(64, 64, 32, 32), sparse_feature_size=8,
                  num_indices_per_lookup=4, interaction_op="dot")
# The width checks (phase 3): every kernel at the widths below, each window
# mode at WINDOW_WIDTH, K3 and K3b at RNN_HIDDEN, on tables of WIDTH_ROWS
# (d 12 has no 16-byte lanes in either float dtype: the general instances).
WIDTHS = (4, 8, 12, 16, 128)
K5_WIDTHS = (24, 48, 100)  # more widths of K5's general instance (its mean's order)
WINDOW_WIDTH = 8
RNN_HIDDEN = (4, 8, 32)
WIDTH_ROWS = (3000, 500, 2000)
WIDTH_BATCH = 64
# The paths at new widths: dien's tables at this scale, and the f32 limit
# of a forward on the card against the CPU's (the order of f32 sums).
WIDTH_PATH_SCALE = 100
WIDTH_PATH_ATOL = 1e-5
DEDUP_MODELS = ("rm1", "rm2")
HOTCOLD_SHARD = {"none": "embedding_bag_hotcold_shard",
                 "int8": "embedding_bag_hotcold_int8_shard",
                 "int8_rowwise": "embedding_bag_hotcold_int8_rowwise_shard"}
# Phase 18, a mesh across processes: DIST_PROCS processes share the card,
# each with MESH_SHARDS / DIST_PROCS entries of it; rm1 at full size, the
# bf16 forward at BATCH on each shape of DIST_FWD_AXES (DIST_FWD_BATCHES
# batches) and, in each int8 layout, on DIST_QUANT_AXES; the f32 dense and
# sparse steps at TRAIN_BATCH on DIST_TRAIN_AXES (DIST_STEPS steps each),
# then DIST_TIMED more of each, timed. In each table layout, rm1 also runs
# the paths of DIST_LAYOUT_PATHS at BATCH on phase 16's zipf(1.2) stream
# (seed 31, the JAX hot-set rule): one checked forward, then DIST_TIMED
# timed. The children report within DIST_WAIT_S.
DIST_PROCS = 2
DIST_FWD_AXES = ((2, 2), (1, 4))
DIST_QUANT_AXES = (1, 4)
DIST_FWD_BATCHES = 2
DIST_TRAIN_AXES = (1, 4)
DIST_STEPS = 2
DIST_TIMED = 10
DIST_WAIT_S = 420
DIST_LAYOUT_PATHS = (("table-wise", 1, 4), ("hot/cold tensor-parallel", 1, 4),
                     ("hot/cold hybrid", 2, 2))
DIST_KERNEL_ITERS = 20  # each route's kernel timed at its first cell's shapes
DIST_LABEL = "two processes on one card, collectives through the host over gloo: no scaling shown"
# Phase 18's part over nccl (two cards or more): DIST_NCCL_PATHS by the
# number of processes, each on a card of its own; rm1 at full size, f32 and
# with bf16 params (DIST_NCCL_MODES), batch TRAIN_BATCH, GRAPH_STEPS steps in
# two arms (the trainer's programs: a CUDA graph a process that holds its
# NCCL collectives; the step function called eagerly) held together by the
# GRAPH_* limits, then timed in turns (graphed, eager, eager, graphed),
# DIST_NCCL_TIMED steps a turn, the processes meeting at a barrier before
# each turn, the loss read back each step. The children report within
# DIST_NCCL_WAIT_S, else every one is killed.
DIST_NCCL_PATHS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
DIST_NCCL_MODES = ("dense", "sparse", "sparse bf16")
DIST_NCCL_TIMED = 10
DIST_NCCL_WAIT_S = 600
# Phase 19, the port's tools on the card, each from its main(argv) and
# read back from its record: the two soaks for TOOL_SOAK_MINUTES, sampled
# every TOOL_SAMPLE_S (the cpu-mp soak's one exhaustion cycle at its first
# sample; the ragged soak's head rotated every TOOL_PHASE_REQUESTS
# requests), mesh_bench on each of TOOL_MESHES (rm1 at TABLE_SCALE),
# sim_revalidate and refresh_scan_cost on rm1. Each records under
# TOOLS_OUT; the first TOOL_CHECKED launches of each kernel on a path are
# held to its plain version (the later ones run unchecked, so the times are
# the tools' own).
TOOL_SOAK_MINUTES = 0.75
TOOL_SAMPLE_S = 15.0
TOOL_PHASE_REQUESTS = 200
TOOL_MIN_REFRESHES = 2
TOOL_MESHES = ((1, 4), (2, 2))
TOOL_CHECKED = 8
TOOLS_OUT = ROOT / "chiprun_out" / "tools"


def _log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _bf16(params: dict) -> dict:
    """The float params in bf16; int8 tables and their f32 scales as they
    are (``bridge.init_numpy``'s bf16 tree of the same seed)."""
    out = {k: bridge.tree_map(lambda t: t.bfloat16(), v) for k, v in params.items()}
    if isinstance(params["tables"], dict):
        out["tables"] = params["tables"]
    return out


def bf16_atol(want: np.ndarray) -> float:
    """Two bf16 ulps of the largest |value| of ``want``."""
    big = max(float(np.abs(want).max()), float(np.finfo(np.float32).tiny))
    return 2.0 * 2.0 ** (np.floor(np.log2(big)) - 7)


def _wrappers() -> dict:
    """The kernel wrappers by KERNELS name (looked up at each call, so a CPU
    rehearsal can put counting shims in their place)."""
    return {"embedding_bag": embedding_bag, "rnn_scan": rnn_scan,
            "embedding_bag_backward": embedding_bag_backward,
            "sparse_adagrad_step": sparse_adagrad_step, "rnn_scan_backward": rnn_scan_backward,
            "optimizer_update": optimizer_update,
            "embedding_bag_int8": embedding_bag_int8,
            "embedding_bag_int8_rowwise": embedding_bag_int8_rowwise,
            "embedding_bag_hotcold": embedding_bag_hotcold,
            "embedding_bag_hotcold_int8": embedding_bag_hotcold_int8,
            "embedding_bag_hotcold_int8_rowwise": embedding_bag_hotcold_int8_rowwise,
            "embedding_bag_shard": embedding_bag_shard,
            "embedding_bag_int8_shard": embedding_bag_int8_shard,
            "embedding_bag_int8_rowwise_shard": embedding_bag_int8_rowwise_shard,
            "embedding_bag_hotcold_shard": embedding_bag_hotcold_shard,
            "embedding_bag_hotcold_int8_shard": embedding_bag_hotcold_int8_shard,
            "embedding_bag_hotcold_int8_rowwise_shard": embedding_bag_hotcold_int8_rowwise_shard,
            "embedding_bag_backward_shard": embedding_bag_backward_shard,
            "sparse_adagrad_step_shard": sparse_adagrad_step_shard}


def _reset_counts():
    for w in _wrappers().values():
        w.kernel_launches = 0


def _counts() -> dict:
    return {k: w.kernel_launches for k, w in _wrappers().items()}


def _want(**launches) -> dict:
    """Expected launches: those named, 0 for every other kernel."""
    return {k: launches.get(k, 0) for k in KERNELS}


def _add(total: dict, counts: dict):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _check_pooled(got, want, table, offsets, indices, mask, what: str,
                  tolerance=pooled_tolerance, kernel: str = "K1") -> float:
    tol = tolerance(got, want, table, offsets, indices, mask)
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{kernel} disagrees with the plain version ({what}): "
                             f"max |err| {err.max().item():.3e}, "
                             f"{int((err > tol).sum())} elements over tolerance")
    return err.max().item()


def _plain_pooled(tables, offsets, indices, cdt) -> torch.Tensor:
    """The plain version of the lookup that the table's layout takes."""
    if not isinstance(tables, dict):
        return embedding_bag_reference(tables, offsets, indices, compute_dtype=cdt)
    if "qrows" in tables:
        return embedding_bag_int8_rowwise_reference(tables["qrows"], offsets, indices,
                                                    compute_dtype=cdt)
    return embedding_bag_int8_reference(tables["q"], tables["scale"], offsets, indices,
                                        compute_dtype=cdt)


def _table_bytes(tables) -> int:
    ts = tables.values() if isinstance(tables, dict) else [tables]
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- phases

def phase_card() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    _log(f"[1 card] {name}; device count {count}; nvidia-smi: {card}")
    return {"kind": name, "count": count, "card": card}


def phase_build() -> dict:
    """Build every kernel, one nvcc a source, all at once."""
    t0 = time.perf_counter()
    sources = list(dict.fromkeys(Path(k["source"]).stem for k in KERNELS.values()))
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    for name, b in builds.items():
        how = f"built in {b.seconds:.2f} s" if b.seconds else "reused from an earlier build"
        _log(f"[2 build] {b.path.name}: {how}; ptxas (template arguments: registers, "
             f"spills): " + "; ".join(ptxas_summary(b.log)))
    _log(f"[2 build] all kernels in {time.perf_counter() - t0:.2f} s")
    return builds


def _case_inputs(device, cfg, B: int, tail: int | None, seed: int):
    """A generator, ``cfg``'s offsets, ``(B, T, L)`` ids and a mask for the
    kernel cases. ``tail``: ids drawn from the last ``tail`` rows of each
    table (reaching the far end of the fused table); None = the port's
    generator."""
    rows, T, L = cfg.scaled_rows, cfg.num_tables, cfg.num_indices_per_lookup
    g = torch.Generator(device=device).manual_seed(seed)
    offsets = table_offsets(cfg, device)
    if tail is None:
        indices = torch.as_tensor(
            RecDataGenerator(cfg, seed=seed).generate_batch(B).indices).to(device)
    else:
        last = torch.as_tensor(rows, dtype=torch.int64, device=device)[None, :, None] - 1
        indices = (last - torch.randint(0, tail, (B, T, L), generator=g,
                                        device=device)).to(torch.int32)
    mask = torch.rand((B, T, L), generator=g, device=device) < 0.7
    return g, offsets, indices, mask


def kernel_cases(device, cfg, B: int, tail: int | None, seed: int) -> float:
    """K1 against embedding_bag_reference for bf16 and f32 tables of
    ``cfg``'s rows, width and pooling, with and without a mask. ``tail``:
    ids drawn from the last ``tail`` rows of each table (reaching the far
    end of the fused table); None = the port's generator. Returns the max
    |error|."""
    rows, d = cfg.scaled_rows, cfg.sparse_feature_size
    g, offsets, indices, mask = _case_inputs(device, cfg, B, tail, seed)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        table = torch.empty((sum(rows), d), dtype=dt, device=device)
        table.uniform_(-1.0, 1.0, generator=g)
        nbytes = table.numel() * table.element_size()
        for m in (None, mask):
            what = (f"{cfg.model_name}: {sum(rows)} x {d} {str(dt)[6:]} table "
                    f"({nbytes / 1e9:.3f} GB), B={B} T={T} L={L}, "
                    f"mask={'yes' if m is not None else 'no'}")
            got = embedding_bag(table, offsets, indices, mask=m)
            synchronize(device)
            want = embedding_bag_reference(table, offsets, indices, mask=m)
            err = _check_pooled(got, want, table, offsets, indices, m, what)
            worst = max(worst, err)
            _log(f"[3 kernel] K1 ok {what}: max |err| {err:.3e}")
        del table
        torch.cuda.empty_cache()
    return worst


def int8_kernel_cases(device, cfg, B: int, tail: int | None, seed: int) -> dict:
    """K1-int8 and K4 against their plain versions on int8 tables of
    ``cfg``'s rows and width (random values, positive random scales: a
    table's, a row's), ``cfg``'s pooling, f32 and bf16 outputs, with and
    without a mask: K1-int8 bit for bit, K4 within ``rowwise_tolerance``.
    ``tail`` as ``kernel_cases``'. Returns the max |error| by kernel."""
    g, offsets, indices, mask = _case_inputs(device, cfg, B, tail, seed)
    t = random_int8_tables(cfg, g, device)
    errs = {"embedding_bag_int8": 0.0, "embedding_bag_int8_rowwise": 0.0}
    for cdt in (torch.bfloat16, torch.float32):
        for m in (None, mask):
            what = (f"{cfg.model_name}: {cfg.total_rows} rows, d = {cfg.sparse_feature_size} "
                    f"({t['q'].numel() / 1e9:.3f} GB per-table, {t['qrows'].numel() / 1e9:.3f} "
                    f"GB row-wise), B={B} T={cfg.num_tables} L={cfg.num_indices_per_lookup}, "
                    f"out {str(cdt)[6:]}, mask={'yes' if m is not None else 'no'}")
            got = embedding_bag_int8(t["q"], t["scale"], offsets, indices, compute_dtype=cdt,
                                     mask=m)
            synchronize(device)
            want = embedding_bag_int8_reference(t["q"], t["scale"], offsets, indices,
                                                compute_dtype=cdt, mask=m)
            if got.dtype != cdt or not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"K1-int8 differs from its plain version ({what}): "
                                     f"max |err| {err:.3e}")
            got = embedding_bag_int8_rowwise(t["qrows"], offsets, indices, compute_dtype=cdt,
                                             mask=m)
            synchronize(device)
            want = embedding_bag_int8_rowwise_reference(t["qrows"], offsets, indices,
                                                        compute_dtype=cdt, mask=m)
            err = _check_pooled(got, want, t["qrows"], offsets, indices, m, what,
                                tolerance=rowwise_tolerance, kernel="K4")
            errs["embedding_bag_int8_rowwise"] = max(errs["embedding_bag_int8_rowwise"], err)
            _log(f"[3 kernel] K1-int8 ok (bit for bit), K4 ok (max |err| {err:.3e}) {what}")
    del t
    _free(device)
    return errs


def _edge_int8(device, rows: tuple, d: int, B: int, L: int, seed: int, value=None,
               start: int = 0, ids=None, masked: bool = False) -> dict:
    """Small int8 tables of ``rows`` (values ``value`` or random in [-128,
    127], positive scales), ``qrows`` starting ``start`` bytes past a
    16-byte boundary at the end of a storage of their own; ids ``ids(t, n,
    g)`` a table, else uniform; a random mask when ``masked``."""
    g = torch.Generator(device=device).manual_seed(seed)
    R, T = sum(rows), len(rows)
    offsets = torch.as_tensor(np.cumsum((0,) + rows[:-1]), dtype=torch.int32, device=device)
    q = torch.randint(-128, 128, (R, d), generator=g, device=device, dtype=torch.int8)
    if value is not None:
        q.fill_(value)
    scale = torch.rand((T,), generator=g, device=device) * 1e-2 + 1e-4
    row_scale = torch.rand((R,), generator=g, device=device) * 1e-2 + 1e-4
    qrows = torch.empty((start + R * (d + 4),), dtype=torch.int8, device=device)[start:]
    qrows = qrows.view(R, d + 4)
    qrows.copy_(torch.cat([q, row_scale.view(torch.int8).reshape(R, 4)], dim=1))
    draw = ids or (lambda t, n, g: torch.randint(0, n, (B, L), generator=g, device=device))
    indices = torch.stack([draw(t, n, g) for t, n in enumerate(rows)], dim=1).to(torch.int32)
    mask = (torch.rand(indices.shape, generator=g, device=device) < 0.7) if masked else None
    return {"q": q, "scale": scale, "qrows": qrows, "offsets": offsets, "indices": indices,
            "mask": mask}


def _check_int8_pair(c: dict, what: str, k1_int8: bool = True) -> float:
    """K1-int8 bit for bit (when ``k1_int8``) and K4 within rowwise_tolerance
    on ``_edge_int8``'s inputs, f32 and bf16 out; K4's max |error|."""
    worst = 0.0
    for cdt in (torch.float32, torch.bfloat16):
        args = (c["offsets"], c["indices"])
        if k1_int8:
            got = embedding_bag_int8(c["q"], c["scale"], *args, compute_dtype=cdt, mask=c["mask"])
            synchronize(c["q"].device)
            if not torch.equal(got, embedding_bag_int8_reference(
                    c["q"], c["scale"], *args, compute_dtype=cdt, mask=c["mask"])):
                raise AssertionError(f"K1-int8 differs from its plain version ({what})")
        got = embedding_bag_int8_rowwise(c["qrows"], *args, compute_dtype=cdt, mask=c["mask"])
        synchronize(c["q"].device)
        want = embedding_bag_int8_rowwise_reference(c["qrows"], *args, compute_dtype=cdt,
                                                    mask=c["mask"])
        worst = max(worst, _check_pooled(got, want, c["qrows"], *args, c["mask"], what,
                                         tolerance=rowwise_tolerance, kernel="K4"))
    return worst


def int8_edge_cases(device) -> float:
    """K1-int8 and K4 where their designs could slip, at a small size: K4
    on rows of each 16-byte phase (ids of one residue mod 4 in a table on a
    16-byte boundary read rows of one phase), on tables that start 4, 8 or
    12 bytes past a 16-byte boundary and end where their storage ends with
    the last rows read; K1-int8 (bit for bit) and K4 on bags of 257, 258,
    300 and 5000 rows, all -128, all 127 or random, masked and not.
    Returns K4's max |error|."""
    worst = 0.0
    for d in (32, 64):
        for phase in range(4):
            c = _edge_int8(device, (4000, 400, 8000), d, 37, 23, phase,
                           ids=lambda t, n, g, p=phase: torch.randint(
                               0, n // 4, (37, 23), generator=g, device=device) * 4 + p)
            worst = max(worst, _check_int8_pair(c, f"K4 phase {phase}, d={d}", k1_int8=False))
        for start in (0, 4, 8, 12):
            c = _edge_int8(device, (3000, 2000), d, 33, 20, start, start=start,
                           ids=lambda t, n, g: n - 1 - torch.randint(
                               0, 64, (33, 20), generator=g, device=device))
            worst = max(worst, _check_int8_pair(c, f"K4 start +{start} B, d={d}",
                                                k1_int8=False))
        for L in (257, 258, 300, 5000):
            for value in (-128, 127, None):
                for masked in (False, True):
                    c = _edge_int8(device, (6000, 300), d, 3, L, L, value=value, masked=masked)
                    worst = max(worst, _check_int8_pair(
                        c, f"L={L}, d={d}, values {value or 'random'}, masked={masked}"))
    _log(f"[3 kernel] K1-int8 ok (bit for bit) and K4 ok (max |err| {worst:.3e}) on rows of "
         "every 16-byte phase, tables starting 4/8/12 bytes past 16 and ending their storage, "
         "and bags of 257, 258, 300 and 5000 rows of -128, 127 and random values, masked and "
         "not, at d = 32 and 64")
    return worst


def phase_kernel(device) -> dict:
    """K1, K1-int8 and K4 at every zoo model's full shape (rm1's: 8 x 4 M
    rows, d = 32, L = 80), batch 512. Returns the max |error| by kernel."""
    errs = {"embedding_bag": 0.0}
    for seed, name in enumerate(zoo.MODEL_NAMES):
        cfg = zoo.get_config(name)
        errs["embedding_bag"] = max(errs["embedding_bag"],
                                    kernel_cases(device, cfg, BATCH, None, seed=seed))
        for k, v in int8_kernel_cases(device, cfg, BATCH, None, seed=seed).items():
            errs[k] = max(errs.get(k, 0.0), v)
    # 40 M rows: the bf16 table is 2.56 GB, the f32 one 5.12 GB, so the last
    # rows lie past 2^31 bytes.
    big = zoo.get_config("rm1").replace(embedding_rows=(5_000_000,) * 8)
    kernel_cases(device, big, 64, 100_000, seed=100)
    # 72 M int8 rows of d = 32: 2.30 GB per-table, 2.59 GB row-wise.
    big = zoo.get_config("rm1").replace(embedding_rows=(9_000_000,) * 8)
    int8_kernel_cases(device, big, 64, 100_000, seed=101)
    errs["embedding_bag_int8_rowwise"] = max(errs["embedding_bag_int8_rowwise"],
                                             int8_edge_cases(device))
    return errs


def rnn_inputs(device, T: int, B: int, dtype: torch.dtype, seed: int,
               H: int = KERNEL_HIDDEN) -> dict:
    """Random inputs of K3 at (T, B, H): xproj ~ N(0, 1), W with the
    1/sqrt(H) init, a nonzero bias, seq_lengths in [0, T] (0 and T among
    them where B >= 2) and an initial state."""
    g = torch.Generator(device=device).manual_seed(seed)
    lens = torch.randint(0, T + 1, (B,), generator=g, device=device, dtype=torch.int32)
    if B >= 2:
        lens[:2] = torch.tensor([0, T], dtype=torch.int32)
    return {
        "xproj": torch.randn((T, B, H), generator=g, device=device),
        "h2h_w": (torch.randn((H, H), generator=g, device=device) / H ** 0.5).to(dtype),
        "h2h_b": (torch.randn((H,), generator=g, device=device) * 0.1).to(dtype),
        "h0": torch.randn((B, H), generator=g, device=device) * 0.5,
        "seq_lengths": lens,
    }


def rnn_cases(device, T: int, B: int, seed: int = 0, H: int = KERNEL_HIDDEN,
              phase: str = "3 kernel") -> float:
    """K3 against rnn_scan_reference in f32 and bf16, with and without
    seq_lengths and h0, at hidden size H. Each step is held, teacher-forced,
    to rnn_scan_tolerance, and the free-running scans to K3_*_ATOL. Returns
    the max |error| of the free-running scans."""
    worst = 0.0
    for dt, atol in ((torch.float32, K3_F32_ATOL), (torch.bfloat16, K3_BF16_ATOL)):
        inp = rnn_inputs(device, T, B, dt, seed, H)
        for use_lens in (False, True):
            for use_h0 in (False, True):
                h0 = inp["h0"] if use_h0 else None
                lens = inp["seq_lengths"] if use_lens else None
                args = (inp["xproj"], inp["h2h_w"], inp["h2h_b"], dt)
                got, last = rnn_scan(*args, h0=h0, seq_lengths=lens)
                synchronize(device)
                want, want_last = rnn_scan_reference(*args, h0=h0, seq_lengths=lens)
                what = (f"T={T} B={B} H={H} {str(dt)[6:]}, "
                        f"seq_lengths={'yes' if use_lens else 'no'}, h0={'yes' if use_h0 else 'no'}")
                step, tol = rnn_scan_tolerance(got, inp["xproj"], inp["h2h_w"], inp["h2h_b"],
                                               h0=h0, seq_lengths=lens)
                step_err = (got.float() - step).abs()
                if got.dtype != dt or not bool((step_err <= tol).all()):
                    raise AssertionError(f"K3 step disagrees with its plain step ({what}): "
                                         f"{int((step_err > tol).sum())} elements over "
                                         f"tolerance, max |err| {step_err.max().item():.3e}")
                err = (got.float() - want.float()).abs().max().item()
                if err > atol or (last.float() - want_last.float()).abs().max().item() > atol:
                    raise AssertionError(f"K3 disagrees with its plain loop ({what}): "
                                         f"max |err| {err:.3e} > {atol:.1e}")
                worst = max(worst, err)
                _log(f"[{phase}] K3 ok {what}: max |err| {err:.3e} (limit {atol:.1e}); "
                     f"teacher-forced max |err| {step_err.max().item():.3e}")
    return worst


# ---------------------------------------------------------------- widths

def _width_inputs(device, d: int, L: int, seed: int, B: int = WIDTH_BATCH):
    """Small float, per-table and row-wise int8 tables of WIDTH_ROWS at
    width d, uniform ids of ``(B, T, L)`` and a random mask."""
    c = _edge_int8(device, WIDTH_ROWS, d, B, L, seed, masked=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    c["table"] = torch.empty((sum(WIDTH_ROWS), d), device=device).uniform_(-1, 1, generator=g)
    c["g"] = g
    return c


def _width_split(device, c: dict) -> tuple[torch.Tensor, dict]:
    """Every 7th fused row as the hot set, and the host split of ``c``'s
    ids (masked slots neither hot nor cold)."""
    R = sum(WIDTH_ROWS)
    hot_ids = np.arange(0, R, 7, dtype=np.int64)
    idx = c["indices"].cpu().numpy()
    split = _device_split(device, hotcold_ops.split_hot_cold(
        idx, c["offsets"].cpu().numpy().astype(np.int64), hot_ids,
        cold_buckets=cold_buckets_for(idx.size), slot_mask=c["mask"].cpu().numpy()))
    return torch.as_tensor(hot_ids, device=device), split


def _check_k6_at(device, c: dict, what: str, errs: dict):
    """K6 in the three layouts on ``c``'s tables and a split, against its
    plain version (per-table int8 bit for bit)."""
    hot_ids, split = _width_split(device, c)
    layouts = {"none": c["table"].bfloat16(), "int8": {"q": c["q"], "scale": c["scale"]},
               "int8_rowwise": {"qrows": c["qrows"]}}
    for quant, tables in layouts.items():
        layout = tables if quant == "none" else tables["q" if quant == "int8" else "qrows"]
        hot = layout.index_select(0, hot_ids)
        got = k6_call(quant, hot, tables, split, torch.bfloat16)
        synchronize(device)
        want = k6_call(quant, hot, tables, split, torch.bfloat16, plain=True)
        key = HOTCOLD[quant]
        if quant == "int8":
            if not torch.equal(got, want):
                raise AssertionError(f"K6-int8 differs from its plain version ({what})")
            continue
        rowwise = quant == "int8_rowwise"
        errs[key] = max(errs.get(key, 0.0), _check_pooled(
            got, want, hot, layout, split, None, what,
            tolerance=lambda a, b, h, t, sp, _m: hotcold_tolerance(a, b, h, t, sp,
                                                                    rowwise=rowwise),
            kernel="K6"))


def _check_k5_at(device, c: dict, what: str, errs: dict, window=None):
    """K5 (or its window on the shard ``window``) with f32 and bf16 tables
    against its plain version, within ``sparse_adagrad_tolerance``."""
    offsets, idx = c["offsets"], c["indices"]
    B, T, _ = idx.shape
    d = c["table"].shape[1]
    grad = torch.randn((B, T, d), generator=c["g"], device=device) * 1e-2
    lo, hi = window or (0, sum(WIDTH_ROWS))
    key = "sparse_adagrad_step" if window is None else "sparse_adagrad_step_shard"
    for tdt in (torch.float32, torch.bfloat16):
        table0 = (c["table"][lo:hi] * 0.05).to(tdt)
        acc0 = torch.rand((hi - lo,), generator=c["g"], device=device) * 1e-4
        table, acc = table0.clone(), acc0.clone()
        want_t, want_a = table0.clone(), acc0.clone()
        if window is None:
            sparse_adagrad_step(table, acc, offsets, idx, grad, 0.1)
            sparse_adagrad_step_reference(want_t, want_a, offsets, idx, grad, 0.1)
        else:
            sparse_adagrad_step_shard(table, acc, offsets, idx, grad, lo, 0.1)
            sparse_adagrad_step_reference(want_t, want_a, offsets, idx, grad, 0.1, window=window)
        synchronize(device)
        tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, idx, grad, 0.1,
                                                window=window)
        err = (table.float() - want_t.float()).abs()
        acc_err = (acc - want_a).abs()
        if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
            raise AssertionError(f"K5 disagrees with its plain version ({what}, table "
                                 f"{str(tdt)[6:]}): max |err| table {err.max().item():.3e}, "
                                 f"acc {acc_err.max().item():.3e}")
        errs[key] = max(errs.get(key, 0.0), err.max().item(), acc_err.max().item())


def width_cases(device) -> dict:
    """Every kernel at widths the zoo does not use, at a small size, against
    its plain version with the existing tolerances: K1, K1b, K1-int8, K4,
    K5 and the three K6 modes at each of WIDTHS (short and long bags,
    masked); each window mode at WINDOW_WIDTH on rows [R/4, R/2) of the
    same tables (K1's on its compacted gather for long bags, K5's with
    f32 and bf16 shards, also on ids that repeat); K5 and its window at
    each of K5_WIDTHS; K3 and K3b at each of RNN_HIDDEN. Returns the max
    |error| by kernel, and K1's and K3's by width too."""
    errs: dict = {}
    for d in WIDTHS:
        for L in (3, 40):
            c = _width_inputs(device, d, L, seed=d * 100 + L)
            offsets, idx, mask = c["offsets"], c["indices"], c["mask"]
            R = sum(WIDTH_ROWS)
            what = f"d={d} L={L} B={WIDTH_BATCH} T={len(WIDTH_ROWS)}"
            for dt in (torch.bfloat16, torch.float32):
                table = c["table"].to(dt)
                for m in (None, mask):
                    got = embedding_bag(table, offsets, idx, mask=m)
                    synchronize(device)
                    want = embedding_bag_reference(table, offsets, idx, mask=m)
                    err = _check_pooled(got, want, table, offsets, idx, m,
                                        f"{what} {str(dt)[6:]}")
                    for key in ("embedding_bag", f"embedding_bag d={d}"):
                        errs[key] = max(errs.get(key, 0.0), err)
                grad = torch.randn(idx.shape[:2] + (d,), generator=c["g"], device=device).to(dt)
                got = embedding_bag_backward(grad, offsets, idx, R, mask=mask)
                synchronize(device)
                err = (got - embedding_bag_backward_reference(grad, offsets, idx, R,
                                                              mask=mask)).abs()
                if not bool((err <= backward_tolerance(grad, offsets, idx, R, mask)).all()):
                    raise AssertionError(f"K1b disagrees with its plain version ({what})")
                errs["embedding_bag_backward"] = max(errs.get("embedding_bag_backward", 0.0),
                                                     err.max().item())
            errs["embedding_bag_int8_rowwise"] = max(errs.get("embedding_bag_int8_rowwise", 0.0),
                                                     _check_int8_pair(c, what))
            _check_k5_at(device, c, what, errs)
            _check_k6_at(device, c, what, errs)
            if d == WINDOW_WIDTH:
                width_window_cases(device, c, what, errs)
            _log(f"[3 widths] K1, K1b, K1-int8, K4, K5 and K6 (three layouts) ok at {what}"
                 + (", and every window mode" if d == WINDOW_WIDTH else ""))
    for d in K5_WIDTHS:
        c = _width_inputs(device, d, 40, seed=d * 100 + 40)
        what = f"d={d} L=40 B={WIDTH_BATCH} T={len(WIDTH_ROWS)}"
        R = sum(WIDTH_ROWS)
        _check_k5_at(device, c, what, errs)
        _check_k5_at(device, c, what, errs, window=(R // 4, R // 2))
        _log(f"[3 widths] K5 and its window ok at {what}")
    for H in RNN_HIDDEN:
        err = rnn_cases(device, DIEN_T, WIDTH_BATCH, H, H, "3 widths")
        for key in ("rnn_scan", f"rnn_scan H={H}"):
            errs[key] = max(errs.get(key, 0.0), err)
        errs["rnn_scan_backward"] = max(errs.get("rnn_scan_backward", 0.0), train_rnn_cases(
            device, DIEN_T, WIDTH_BATCH, H, H, "3 widths"))
    return errs


def width_window_cases(device, c: dict, what: str, errs: dict):
    """Each window mode on rows [R/4, R/2) of ``c``'s tables: K1's (f32
    partial of bf16 and f32 shards), K1-int8's (exact), K4's, K1b's, K5's
    (f32 and bf16 shards) and K6 on a shard's cold stream in the three
    layouts, with hits and on the cold-only route, each against its plain
    version."""
    offsets, idx, mask = c["offsets"], c["indices"], c["mask"]
    R = sum(WIDTH_ROWS)
    lo, hi = R // 4, R // 2
    w = (lo, hi)
    what = f"{what}, shard rows [{lo}, {hi})"
    for dt in (torch.bfloat16, torch.float32):
        shard = c["table"][lo:hi].to(dt)
        for m in (None, mask):
            got = embedding_bag_shard(shard, offsets, idx, lo, mask=m)
            synchronize(device)
            want = embedding_bag_reference(shard, offsets, idx, mask=m, window=w)
            tol = pooled_tolerance(got, want, shard, offsets, idx, m, window=w)
            err = (got - want).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"K1's window disagrees with its plain version ({what})")
            errs["embedding_bag_shard"] = max(errs.get("embedding_bag_shard", 0.0),
                                              err.max().item())
        grad = torch.randn(idx.shape[:2] + (shard.shape[1],), generator=c["g"], device=device)
        got = embedding_bag_backward_shard(grad, offsets, idx, lo, hi - lo, mask=mask)
        synchronize(device)
        err = (got - embedding_bag_backward_reference(grad, offsets, idx, hi - lo, mask=mask,
                                                      window=w)).abs()
        if not bool((err <= backward_tolerance(grad, offsets, idx, hi - lo, mask, w)).all()):
            raise AssertionError(f"K1b's window disagrees with its plain version ({what})")
        errs["embedding_bag_backward_shard"] = max(
            errs.get("embedding_bag_backward_shard", 0.0), err.max().item())
    got = embedding_bag_int8_shard(c["q"][lo:hi], offsets, idx, lo, mask=mask)
    synchronize(device)
    if not torch.equal(got, embedding_bag_int8_reference(c["q"][lo:hi], None, offsets, idx,
                                                         mask=mask, window=w)):
        raise AssertionError(f"K1-int8's window differs from its plain version ({what})")
    qrows = c["qrows"][lo:hi]
    got = embedding_bag_int8_rowwise_shard(qrows, offsets, idx, lo, mask=mask)
    synchronize(device)
    want = embedding_bag_int8_rowwise_reference(qrows, offsets, idx, mask=mask, window=w)
    tol = rowwise_tolerance(got, want, qrows, offsets, idx, mask, window=w)
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"K4's window disagrees with its plain version ({what})")
    errs["embedding_bag_int8_rowwise_shard"] = max(
        errs.get("embedding_bag_int8_rowwise_shard", 0.0), err.max().item())
    _check_k5_at(device, c, what, errs, window=w)
    # And on ids that repeat: 50 rows of table 0 inside the window, each
    # taking many adds, where a bf16 shard rounding at each add would miss
    # the once-rounded rule's bound.
    dup = c["indices"] % 50
    dup[:, 0] += lo + 25
    _check_k5_at(device, {**c, "indices": dup}, f"{what}, 50 rows repeated", errs, window=w)
    # K6 on a shard: the shard's rows as a table of their own, its ids local.
    local = {"table": c["table"][lo:hi], "q": c["q"][lo:hi], "qrows": qrows}
    ids = torch.randint(0, hi - lo, (WIDTH_BATCH, 1, idx.shape[2]), generator=c["g"],
                        device=device, dtype=torch.int32)
    hot_ids = np.arange(0, hi - lo, 5, dtype=np.int64)
    split = _device_split(device, hotcold_ops.split_hot_cold(
        ids.cpu().numpy(), np.zeros(1, dtype=np.int64), hot_ids,
        cold_buckets=cold_buckets_for(ids.numel())))
    hot_idx = torch.as_tensor(hot_ids, device=device)
    for quant, fn, plain in (
            ("none", embedding_bag_hotcold_shard,
             lambda h, t, sp: embedding_bag_hotcold_reference(h, t, sp, partial=True)),
            ("int8", embedding_bag_hotcold_int8_shard,
             lambda h, t, sp: embedding_bag_hotcold_int8_reference(h, t, None, sp, partial=True)),
            ("int8_rowwise", embedding_bag_hotcold_int8_rowwise_shard,
             lambda h, t, sp: embedding_bag_hotcold_int8_rowwise_reference(h, t, sp,
                                                                          partial=True))):
        table = {"none": local["table"].bfloat16(), "int8": local["q"],
                 "int8_rowwise": local["qrows"]}[quant]
        hot = table.index_select(0, hot_idx)
        got = fn(hot, table, split)
        synchronize(device)
        want = plain(hot, table, split)
        key = HOTCOLD_SHARD[quant]
        if quant == "int8":
            if not torch.equal(got, want):
                raise AssertionError(f"K6-int8 on a shard differs from its plain version ({what})")
            continue
        tol = hotcold_tolerance(got, want, hot, table, split, rowwise=quant == "int8_rowwise")
        err = (got - want).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"K6 on a shard ({quant}) disagrees with its plain version "
                                 f"({what})")
        errs[key] = max(errs.get(key, 0.0), err.max().item())
    # The cold-only route (a shard that counts no hot hit) on the same
    # stream: the general instance at this width.
    cold = {"cold_ids": split["cold_ids"], "cold_seg": split["cold_seg"],
            "bags": tuple(split["hot_sel"].shape[:2])}
    for quant in ("none",) + QUANT_MODES:
        table = {"none": local["table"].bfloat16(), "int8": local["q"],
                 "int8_rowwise": local["qrows"]}[quant]
        got = _hotcold_partial(quant, None, table, cold)
        synchronize(device)
        want = _hotcold_partial(quant, None, table, cold, plain=True)
        _merge(errs, HOTCOLD_SHARD[quant], _check_partial(
            quant, got, want, table, f"{what}, K6's cold-only route", _hotcold_tol(quant, None,
                                                                                    cold)))


def width_times(device, card: str) -> dict:
    """K1 at rm1's shape with d = WINDOW_WIDTH (bf16, batch 512, full-size
    table; the 16-byte lanes at one lane a row) and K3 at DIEN's shape with
    H = WINDOW_WIDTH (the general instance), each beside its plain version,
    its bound and its library call, as phases 7 and 9 time the zoo's."""
    cfg = zoo.get_config("rm1").replace(sparse_feature_size=WINDOW_WIDTH)
    g = torch.Generator(device=device).manual_seed(8)
    table = torch.empty((cfg.total_rows, WINDOW_WIDTH), dtype=torch.bfloat16,
                        device=device).uniform_(-0.05, 0.05, generator=g)
    offsets = table_offsets(cfg, device)
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
    with torch.inference_mode():
        k1 = _k1_summary(_k1_runs(table, offsets, batches, torch.bfloat16), batches, table,
                         offsets)
    _log("[3 widths times] " + _k1_line(k1, f"rm1 at d={WINDOW_WIDTH}", card))
    del table, batches
    _free(device)
    k3 = phase_rnn_times(device, card, H=WINDOW_WIDTH, label="3 widths times")
    return {"embedding_bag": k1, "rnn_scan": k3}


def width_path(device, cfg, what: str) -> tuple[float, dict]:
    """``cfg`` (f32) through ``get_model(...).apply`` on the card, three
    batches of BATCH, against the same forward on the CPU (every wrapper's
    plain version there). Returns the max |error| and the launches, read
    around the card's forwards."""
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(6))
    batches = RecDataGenerator(cfg, seed=6).generate_batches(3, BATCH)
    with torch.inference_mode():
        _reset_counts()
        outs = [model.apply(params, b.to(device)) for b in batches]
        synchronize(device)
        counts = _counts()
        cpu_model = get_model(cfg, "cpu")
        cpu_params = bridge.tree_map(lambda t: t.cpu(), params)
        worst = 0.0
        for out, b in zip(outs, batches):
            want = cpu_model.apply(cpu_params, b.to("cpu"))
            _check_scores(out, tuple(want.shape), sigmoid_output(cfg), what)
            err = (out.cpu() - want).abs().max().item()
            if err > WIDTH_PATH_ATOL:
                raise AssertionError(f"{what} on the card differs from the CPU forward: max "
                                     f"|err| {err:.3e} > {WIDTH_PATH_ATOL:.0e}")
            worst = max(worst, err)
    del params, outs
    _free(device)
    return worst, counts


def phase_widths(device, card: str) -> tuple[dict, dict, dict]:
    """The width checks (``width_cases``, their launches read around them
    and each kernel required), then two paths at new widths, each read
    around itself: the dryrun's "dot" DLRM (d = 8, K1's 16-byte lanes at 2
    lanes a row) and dien at H = WINDOW_WIDTH (K3's general instance),
    each against its CPU forward; then ``width_times``. Returns (max
    |error| by kernel and by new instance, e.g. ``"embedding_bag d=8"``,
    over the kernel checks; times; K1's launches on the dryrun's path and
    K3's on dien's)."""
    t0 = time.perf_counter()
    _reset_counts()
    errs = width_cases(device)
    checked = _counts()
    for key in ("embedding_bag", "embedding_bag_backward", "embedding_bag_int8",
                "embedding_bag_int8_rowwise", "sparse_adagrad_step", "rnn_scan",
                "rnn_scan_backward", *HOTCOLD.values(), *SHARD.values(), *HOTCOLD_SHARD.values(),
                "embedding_bag_backward_shard", "sparse_adagrad_step_shard"):
        if checked[key] == 0:
            raise AssertionError(f"the width checks never launched {key}")
    launches = {}
    for cfg, what, key in (
            (ModelConfig(**DRYRUN_CFG), "the dryrun's DLRM (d = 8)", "embedding_bag"),
            (zoo.get_config("dien", table_scale=WIDTH_PATH_SCALE).replace(
                hidden_size=WINDOW_WIDTH), f"dien at H = {WINDOW_WIDTH}", "rnn_scan")):
        err, counts = width_path(device, cfg, what)
        if counts[key] == 0:
            raise AssertionError(f"{what} never launched {key}")
        launches[key] = counts[key]  # the new width's instance: this path's launches only
        _log(f"[3 widths] {what}, f32, batch {BATCH}: 3 forwards within {WIDTH_PATH_ATOL:.0e} "
             f"of the CPU forward (max |err| {err:.3e}); launches {_nonzero(counts)} [{card}]")
    times = width_times(device, card)
    _log(f"[3 widths] every kernel's new widths ok in {time.perf_counter() - t0:.1f} s; "
         f"launches of the checks {_nonzero(checked)}")
    return errs, times, launches


def _zoo_fixture_params(stored, name: str, device,
                        table_quant: str = "none") -> tuple[dict, Batch]:
    """The f32 params of ``name``'s fixture entry (``name/`` in the zoo
    fixture, ``name/<table_quant>/`` in the quant one), redrawn from its
    seed, and its batch."""
    key = f"{name}/" if table_quant == "none" else f"{name}/{table_quant}/"
    cfg = zoo.get_config(name, table_scale=2000, table_quant=table_quant)
    np_params = bridge.init_numpy(cfg, int(stored[f"{key}seed"]))
    if not np.allclose(bridge.fingerprint(np_params), stored[f"{key}fingerprint"],
                       rtol=1e-9, atol=0):
        raise AssertionError(f"{key}: numpy drew other weights from the fixture's seed "
                             "than when the fixture was built (fingerprint differs)")
    dense = stored[f"{key}dense"] if f"{key}dense" in stored.files else None
    batch = Batch(dense, stored[f"{key}indices"]).to(device)
    return bridge.params_from_numpy(np_params, cfg, device), batch


def fixture_model(stored, name: str, device, table_quant: str = "none") -> dict:
    """``name`` at table_scale=2000, f32 and bf16, against the JAX outputs
    in the zoo fixture, or with int8 tables (``table_quant``) in the quant
    fixture (and, for dien, ragged histories with an initial state).
    Returns the max |error| by output."""
    pre = f"{name}/" if table_quant == "none" else f"{name}/{table_quant}/"
    params32, batch = _zoo_fixture_params(stored, name, device, table_quant)
    cases = [("", {})]
    if name == "dien":
        cases.append(("ragged_", {
            "seq_lengths": torch.as_tensor(stored[f"{pre}seq_lengths"]).to(device),
            "initial_h": torch.as_tensor(stored[f"{pre}initial_h"]).to(device)}))
    errs = {}
    for dtype, tag, params in (("float32", "f32", params32),
                               ("bfloat16", "bf16", _bf16(params32))):
        cfg = zoo.get_config(name, table_scale=2000, param_dtype=dtype, compute_dtype=dtype,
                             table_quant=table_quant)
        model = get_model(cfg, device)
        for prefix, kw in cases:
            want = stored[f"{pre}out_{prefix}{tag}"]
            with torch.inference_mode():
                got = model.apply(params, batch, **kw).float().cpu().numpy()
            key = f"{prefix}{tag}"
            errs[key] = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
            ok = got.shape == want.shape and (
                np.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL) if tag == "f32"
                else np.allclose(got, want, rtol=0, atol=bf16_atol(want)))
            if not ok:
                raise AssertionError(f"port {name} {table_quant} {key} differs from the JAX "
                                     f"fixture: max |err| {errs[key]:.3e}")
    return errs


def phase_fixture(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stored = np.load(FIXTURE)
    params32 = bridge.params_from_numpy(
        bridge.unflatten({k: stored[k] for k in stored.files if k == "tables" or "/" in k}),
        zoo.get_config("rm1", table_scale=2000), device)
    batch = Batch(stored["dense"], stored["indices"]).to(device)
    errs = {}
    for dtype, params, want, close in (
            ("float32", params32, stored["out_f32"],
             lambda g, w: np.allclose(g, w, rtol=F32_RTOL, atol=0)),
            ("bfloat16", _bf16(params32), stored["out_bf16"],
             lambda g, w: np.allclose(g, w, rtol=0, atol=BF16_ATOL))):
        cfg = zoo.get_config("rm1", table_scale=2000, param_dtype=dtype, compute_dtype=dtype)
        with torch.inference_mode():
            got = get_model(cfg, device).apply(params, batch).float().cpu().numpy()
        errs[f"rm1 {dtype}"] = float(np.abs(got - want).max())
        if got.shape != want.shape or not close(got, want):
            raise AssertionError(f"port rm1 {dtype} differs from the JAX fixture: "
                                 f"max |err| {errs[f'rm1 {dtype}']:.3e}")
        _log(f"[4 fixture] rm1 table_scale=2000 {dtype} batch {want.shape[0]} matches "
             f"JAX: max |err| {errs[f'rm1 {dtype}']:.3e}")
    zoo_stored = np.load(ZOO_FIXTURE)
    for name in ZOO:
        model_errs = fixture_model(zoo_stored, name, device)
        errs.update({f"{name} {k}": v for k, v in model_errs.items()})
        _log(f"[4 fixture] {name} table_scale=2000 matches JAX: max |err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in model_errs.items()))
    quant_stored = np.load(QUANT_FIXTURE)
    for name in zoo.MODEL_NAMES:
        for quant in QUANT_MODES:
            model_errs = fixture_model(quant_stored, name, device, table_quant=quant)
            errs.update({f"{name} {quant} {k}": v for k, v in model_errs.items()})
            _log(f"[4 fixture] {name} table_scale=2000 {quant} tables match JAX: max |err| "
                 + ", ".join(f"{k} {v:.3e}" for k, v in model_errs.items()))
    return errs


def _check_scores(out: torch.Tensor, shape: tuple, sigmoid: bool, what: str):
    o = out.float()
    ok = tuple(o.shape) == shape and bool(torch.isfinite(o).all())
    ok = ok and bool(((o >= 0) & (o <= 1)).all() if sigmoid else (o >= 0).all())
    if not ok:
        raise AssertionError(f"{what}: scores not finite "
                             f"{'in [0, 1]' if sigmoid else '>= 0'} of shape {shape}")


def phase_forward(device) -> dict:
    """rm1 at full width through get_model(...).apply and main.py's loop."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    data = RecDataGenerator(cfg, seed=1)
    batches = [b.to(device) for b in data.generate_batches(3, BATCH)]
    with torch.inference_mode():
        before = embedding_bag.kernel_launches
        outs = [model.apply(params, b) for b in batches]
        synchronize(device)
        if embedding_bag.kernel_launches - before != len(batches):
            raise AssertionError("K1 did not launch once per rm1 forward")
        offsets = table_offsets(cfg, device)
        worst = 0.0
        for b, out in zip(batches, outs):
            _check_scores(out, (BATCH, 1), True, "rm1 forward")
            pooled = embedding_bag_reference(params["tables"], offsets, b.indices,
                                             compute_dtype=torch.bfloat16)
            plain = model.apply_from_pooled(params, pooled, b)
            worst = max(worst, (out.float() - plain.float()).abs().max().item())
        if worst > BF16_ATOL:
            raise AssertionError(f"rm1 forward differs from its plain path: {worst:.3e}")
    _log(f"[5 forward] rm1 table_scale={TABLE_SCALE} bf16 batch {BATCH}: {len(batches)} forwards, "
         f"scores finite in [0, 1], max |kernel - plain path| {worst:.3e}")

    before = embedding_bag.kernel_launches
    res = port_main.main(["--model", "rm1", "--param_dtype", "bfloat16",
                          "--mini_batch_size", str(BATCH), "--num_batches", "4",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    if embedding_bag.kernel_launches - before != res["forwards"]:
        raise AssertionError("main.py's loop did not launch K1 once per forward")
    for out in res["outputs"]:
        _check_scores(out, (BATCH, 1), True, "main.py forward")
    _log(f"[5 forward] main.py standalone loop: {res['forwards']} forwards, "
         f"compute {res['compute_ms']:.3f} ms for 4 batches")
    return {"cfg": cfg, "model": model, "params": params, "batches": batches}


def _backend(device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _peak_gib(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _check_served(res, counts: dict, scans_per_execution: int, what: str,
                  drained: bool = False, lookup: str = "embedding_bag"):
    """Every sub-request answered without an error (but those a tuning run's
    drain-and-settle removed from the queue, with ``drained``), and each
    kernel launched once a model execution (the ``lookup`` kernel of the
    table's layout; K3 twice for dien), warm-up included."""
    if res.engine_errors:
        raise AssertionError(f"{what}: engines failed: {res.engine_errors}")
    if res.error_responses != 0 or (
            res.num_responses > res.cpu_sub_requests if drained
            else res.num_responses != res.cpu_sub_requests):
        raise AssertionError(f"{what}: {res.num_responses} responses for "
                             f"{res.cpu_sub_requests} sub-requests, "
                             f"{res.error_responses} of them errors")
    want = _want(**{lookup: res.executions}, rnn_scan=scans_per_execution * res.executions)
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {want} for "
                             f"{res.executions} executions (warm-up included)")
    if not (np.isfinite(res.p95_ms) and res.measured_qps > 0):
        raise AssertionError(f"{what}: no latency or QPS measured")


def _served_line(res, counts: dict) -> str:
    return (f"QPS {res.measured_qps:.2f}; p50 {res.p50_ms:.3f} ms, p95 "
            f"{res.p95_ms:.3f} ms, p99 {res.p99_ms:.3f} ms; queue-wait p95 "
            f"{res.queue_wait_p95_ms:.3f} ms, inference p95 {res.inference_p95_ms:.3f} ms; "
            f"{res.cpu_requests} queries, {res.cpu_sub_requests} sub-requests, "
            f"{res.num_responses} responses, {res.error_responses} errors; executions a "
            f"bucket {res.bucket_counts} + {res.warmup_executions} warm-up; launches "
            f"{counts}; pacing error mean {res.pacing_error_mean_ms:.4f} ms, p99 "
            f"{res.pacing_error_p99_ms:.4f} ms; wall {res.wall_s:.2f} s")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _programs_line(eng) -> str:
    pool = eng.graph_pool_bytes
    return (f"{len(eng.programs)} programs, {eng.graph_captures} graphs captured in "
            f"{eng.capture_ms:.1f} ms, graph pool "
            + ("not measured" if pool is None else f"{pool / 2**20:.1f} MiB"))


def check_programs(device, eng, model, params, what: str) -> float:
    """Each of ``eng``'s programs: its first replay (at warm-up) against
    ``model.apply`` with ``params`` on the rows it was warmed on (a hot/cold
    program: the hot/cold model's eager forward on its split and the
    engine's params; on a mesh the mesh split and the sharded params), and
    against the eager forward the engine ran before capturing it, within
    bf16_atol; on a card every program must hold a graph and the engine no
    eager reason. Returns the max |err|. Call after the path's launches
    were read: these forwards launch too."""
    if device.type == "cuda" and (eng.eager_reason is not None
                                  or eng.graph_captures < len(eng.programs)):
        raise AssertionError(f"{what}: {eng.graph_captures} graphs for {len(eng.programs)} "
                             f"programs (eager reason: {eng.eager_reason})")
    worst = 0.0
    with torch.inference_mode():
        for prog in eng.programs:
            rows = eng.warm_inputs(prog.key)
            dense = rows["dense"].to(device) if "dense" in rows else None
            if prog.key[0] == "hotcold":
                keys = ("hot_sel", "hot_mask", eng._static.cold_key, "cold_seg")
                out = eng._hotcold.apply(eng.params, Batch(dense=dense, indices=None),
                                         {k: rows[k].to(device) for k in keys})
            else:
                mask = rows["mask"].to(device) if "mask" in rows else None
                out = model.apply(params, Batch(dense=dense, indices=rows["indices"].to(device),
                                                mask=mask))
            want = out.float().cpu().numpy()
            err = max(float(np.abs(prog.first_scores - want).max()), prog.warm_err or 0.0)
            if (device.type == "cuda" and prog.graph is None) or err > bf16_atol(want):
                raise AssertionError(f"{what}: program {prog.key}'s first replay differs from "
                                     f"the eager forward by {err:.3e} > {bf16_atol(want):.3e} "
                                     f"(captured: {prog.graph is not None})")
            worst = max(worst, err)
    return worst


def serve_rm1(device, engines: int, card: str, table_quant: str = "none",
              phase: str = "6 serving") -> tuple[dict, dict]:
    """rm1 at the canonical point through ``run_serving``, each engine with
    its own params from its seed (``table_quant``: int8 tables), then each
    engine's programs held to the eager forward on its params
    (``check_programs``). Returns the result and the launches."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=table_quant)
    scfg = ServingConfig(**SERVING_POINT, num_batches=SERVE_QUERIES,
                         inference_engines=engines, engine_backend=_backend(device))
    _reset_peak(device)
    _reset_counts()
    with _engines_of_runs() as built:
        res = run_serving(cfg, scfg, settle_s=0.1)
    counts = _counts()
    what = f"rm1 {table_quant} tables" if table_quant != "none" else "rm1"
    _check_served(res, counts, 0, f"{what} served by {engines} engine(s)",
                  lookup=LOOKUP[table_quant])
    peak = _peak_gib(device)
    model = get_model(cfg, device)
    errs = [check_programs(device, e, model, e.params, f"{what} engine {e.engine_id}")
            for e in built]
    _log(f"[{phase}] {what} table_scale={TABLE_SCALE} bf16, {engines} engine(s): "
         f"{_served_line(res, counts)}; peak device memory {peak:.3f} GiB; each engine "
         + "; ".join(_programs_line(e) for e in built)
         + f"; every program's first replay within bf16_atol of model.apply on its rows (max "
         f"|err| {max(errs):.3e}) [{card}]")
    programs = [{"programs": len(e.programs), "captures": e.graph_captures,
                 "capture_ms": e.capture_ms, "pool_bytes": e.graph_pool_bytes} for e in built]
    del built
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"engines": engines, **res.to_dict(), "peak_gib": peak, "programs": programs,
            "program_err": max(errs)}, counts


def serve_programs(device, card: str) -> tuple[dict, dict]:
    """One engine of each of ``PROGRAM_ENGINES`` at the canonical ladder,
    its params from seed 0: its warm-up launches (an eager forward and a
    replay a program on a card, each one lookup, K3 twice for dien) read
    when it is ready, then every program held to the eager forward
    (``check_programs``). Returns the rows by engine and the launches."""
    launches, out = _want(), {}
    per = 2 if device.type == "cuda" else 1  # warm-up executions a program
    for name, quant, impl in PROGRAM_ENGINES:
        t0 = time.perf_counter()
        cfg = zoo.get_config(name, table_scale=TABLE_SCALE, param_dtype="bfloat16",
                             compute_dtype="bfloat16", table_quant=quant, embedding_impl=impl,
                             hot_set_rows=PROGRAM_HOT_ROWS)
        model = get_model(cfg.replace(embedding_impl="xla"), device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device), accept_ragged=True,
                             hotcold_refresh_interval=REFRESH_INTERVAL if impl == "hotcold" else 0)
        what = f"{name} {quant} tables{' hot/cold' if impl == 'hotcold' else ''}"
        _reset_peak(device)
        _reset_counts()
        req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device=device, params=params)
        eng.start()
        try:
            ready = ready_q.get(timeout=600)
            if isinstance(ready, Exception):
                raise RuntimeError(f"{what}: the engine failed during setup") from ready
            counts = _counts()
            split = per * sum(p.key[0] == "hotcold" for p in eng.programs)
            direct = eng.warmup_executions - split
            want = _want(**{LOOKUP[quant]: direct, HOTCOLD[quant]: split},
                         rnn_scan=2 * direct if name == "dien" else 0)
            if counts != want or eng.warmup_executions != per * len(eng.programs):
                raise AssertionError(f"{what}: warm-up launches {counts}, expected {want} for "
                                     f"{eng.warmup_executions} executions of "
                                     f"{len(eng.programs)} programs")
            _add(launches, counts)
            direct_params = {k: v for k, v in eng.params.items() if k != "hot_table"}
            err = check_programs(device, eng, model, direct_params, what)
        finally:
            req_q.put(None)
            eng.join(timeout=120)
        peak = _peak_gib(device)
        rungs = sorted({p.key[2] for p in eng.programs if p.key[0] == "hotcold"})
        _log(f"[6 serving] {what} engine at the canonical ladder {list(eng.buckets)}, ragged "
             f"accepted{f', cold rungs {rungs}' if rungs else ''}: {_programs_line(eng)}; "
             f"warm-up launches {_nonzero(counts)} for {eng.warmup_executions} executions; every "
             f"program's first replay within bf16_atol of the eager forward on its rows (max "
             f"|err| {err:.3e}, replay against the engine's own eager run "
             f"{max((p.warm_err or 0.0) for p in eng.programs):.3e}); peak device memory "
             f"{peak:.3f} GiB; {time.perf_counter() - t0:.1f} s [{card}]")
        out[what] = {"programs": len(eng.programs), "captures": eng.graph_captures,
                     "capture_ms": eng.capture_ms, "pool_bytes": eng.graph_pool_bytes,
                     "max_abs_err": err, "peak_gib": peak}
        del eng, params, direct_params
        _free(device)
    return out, launches


def serve_capacity(device, fwd: dict, card: str) -> tuple[dict, dict]:
    """engine_bench's engine arm on phase 5's rm1 params: CAPACITY_EXECUTIONS
    executions of CAPACITY_ROWS rows, the queue never empty, through 1 and
    4 engines, the timed window traced (the device's idle share: how far
    the host holds the card back); every execution one K1 launch."""
    out, launches = {}, _want()
    for engines in (1, 4):
        built = []

        def pool_fn(*args, **kwargs):
            pool, total = build_engine_pool(*args, **kwargs)
            built.extend(pool)
            return pool, total
        _reset_counts()
        t0 = time.perf_counter()
        r = engine_arm(fwd["cfg"], _backend(device), engines, CAPACITY_EXECUTIONS, CAPACITY_ROWS,
                       params=fwd["params"], pool_fn=pool_fn, profile=device.type == "cuda")
        counts = _counts()
        ex = sum(_executions(e) for e in built)
        if counts != _want(embedding_bag=ex):
            raise AssertionError(f"closed loop, {engines} engine(s): launches {counts} for {ex} "
                                 f"executions")
        _add(launches, counts)
        idle = r.get("idle_share")
        _log(f"[6 serving] rm1 closed loop (engine_bench's engine arm), {engines} engine(s), "
             f"{CAPACITY_EXECUTIONS} executions of {CAPACITY_ROWS} rows, the window traced: "
             f"{r['executions_per_s']:.1f} executions/s, inference p50 "
             f"{r['inference_p50_ms']:.3f} ms, {r['cpu_ms_per_execution']:.3f} CPU ms an "
             f"execution; device busy "
             + ("not measured" if idle is None else
                f"{r['device_busy_ms']:.1f} ms of {r['seconds'] * 1e3:.1f}, idle {idle:.1%}")
             + f"; launches {_nonzero(counts)} for {ex} executions; "
             f"{time.perf_counter() - t0:.1f} s [{card}]")
        out[engines] = r
        del built
        _free(device)
    return out, launches


def serve_payloads(device, fwd: dict) -> tuple[float, dict]:
    """Payload requests through one rm1 engine on phase 5's params: their
    scores against ``model.apply`` on the same rows (bf16_atol: the bucket's
    GEMMs may take another cuBLAS algorithm than the reference batch's);
    an id past its table is answered ERR_PAYLOAD. Returns the max |error|
    and the launches."""
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device))
    data = RecDataGenerator(cfg, seed=4)
    payloads = [data.generate_batch(n) for n in (32, 17, 100)]
    bad = data.generate_batch(8)
    bad.indices[3, 5, 7] = cfg.scaled_rows[5]
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    _reset_counts()
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device=device, params=params)
    eng.start()
    ready = ready_q.get(timeout=120)
    if isinstance(ready, Exception):
        raise RuntimeError("the payload engine failed during setup") from ready
    for i, p in enumerate(payloads + [bad]):
        req_q.put(ServiceRequest(batch_id=i, batch_size=len(p.indices),
                                 arrival_time=time.time(), payload=p))
    req_q.put(None)
    got = {}
    for _ in range(len(payloads) + 1):
        r = resp_q.get(timeout=120)
        got[r.batch_id] = r
    eng.join(timeout=120)
    counts = _counts()
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    if counts != _want(embedding_bag=executions) or eng.error is not None:
        raise AssertionError(f"payload engine: launches {counts} for {executions} "
                             f"executions; error {eng.error!r}")
    if got[len(payloads)].error_code != ERR_PAYLOAD:
        raise AssertionError("an out-of-range id was not answered with ERR_PAYLOAD")
    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(payloads):
            want = model.apply(params, p.to(device)).float().cpu().numpy()
            r = got[i]
            if r.error_code != ERR_OK or r.scores is None or r.scores.shape != want.shape:
                raise AssertionError(f"payload {i}: error {r.error_code}, scores "
                                     f"{None if r.scores is None else r.scores.shape}")
            err = float(np.abs(r.scores - want).max())
            if err > bf16_atol(want):
                raise AssertionError(f"payload {i}: engine scores differ from "
                                     f"model.apply by {err:.3e} > {bf16_atol(want):.3e}")
            worst = max(worst, err)
    _log(f"[6 serving] rm1 payload requests of {[len(p.indices) for p in payloads]} rows "
         f"through one engine match model.apply on the same rows: max |err| {worst:.3e} "
         f"(limit bf16_atol); an id past table 5's {cfg.scaled_rows[5]} rows answered "
         f"ERR_PAYLOAD; launches {counts} for {executions} executions")
    return worst, counts


def serve_tuning(device, fwd: dict, card: str) -> tuple[dict, dict]:
    """A short DeepRecSched run on rm1 (one engine, phase 5's params): the
    hill climber over sub-batches of 32 and 64 picks one."""
    scfg = ServingConfig(**{**SERVING_POINT, "avg_arrival_rate_ms": 5.0},
                         num_batches=40, engine_backend=_backend(device),
                         tune_batch_qps=True, batch_configs=(32, 64), arr_steps=5,
                         sched_timeout=4, req_granularity=8, min_arr_range=2.0,
                         max_arr_range=20.0, target_latency_ms=25.0)
    _reset_counts()
    res = run_serving(fwd["cfg"], scfg, params=fwd["params"], settle_s=0.1)
    counts = _counts()
    if res.optimal_sub_batch not in scfg.batch_configs:
        raise AssertionError(f"tune_batch_qps picked {res.optimal_sub_batch}")
    _check_served(res, counts, 0, "rm1 tuning run", drained=True)
    _log(f"[6 serving] rm1 tune_batch_qps over {scfg.batch_configs}: optimal_sub_batch "
         f"{res.optimal_sub_batch}; after tuning {_served_line(res, counts)} [{card}]")
    return res.to_dict(), counts


def serve_dien(device, card: str) -> tuple[dict, dict]:
    """dien at full width through ``main.py --queue``, one engine."""
    _reset_peak(device)
    _reset_counts()
    res = port_main.main([
        "--model", "dien", "--param_dtype", "bfloat16", "--table_scale", str(TABLE_SCALE),
        "--queue", "--engine_backend", _backend(device), "--num_batches", str(DIEN_QUERIES),
        "--batch_size_distribution", "normal", "--avg_mini_batch_size", "165",
        "--var_mini_batch_size", "16", "--sub_task_batch_size", "32",
        "--avg_arrival_rate", "10"])
    counts = _counts()
    _check_served(res, counts, 2, "dien served by main.py --queue")
    peak = _peak_gib(device)
    _log(f"[6 serving] dien table_scale={TABLE_SCALE} bf16 through main.py --queue, 1 "
         f"engine: {_served_line(res, counts)}; peak device memory {peak:.3f} GiB [{card}]")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {**res.to_dict(), "peak_gib": peak}, counts


def phase_serving(device, fwd: dict, card: str) -> tuple[dict, dict]:
    """The serving stack on the card; each path's launches read around it.
    Returns the results and the launches summed over the paths."""
    t0 = time.perf_counter()
    launches = _want()
    out = {}
    for key, run in (("programs", lambda: serve_programs(device, card)),
                     ("rm1_1", lambda: serve_rm1(device, 1, card)),
                     ("rm1_4", lambda: serve_rm1(device, 4, card)),
                     ("capacity", lambda: serve_capacity(device, fwd, card)),
                     ("payload_err", lambda: serve_payloads(device, fwd)),
                     ("tune", lambda: serve_tuning(device, fwd, card)),
                     ("dien", lambda: serve_dien(device, card))):
        out[key], counts = run()
        _add(launches, counts)
    _log(f"[6 serving] all serving paths in {time.perf_counter() - t0:.1f} s")
    return out, launches


def _top(m: dict, n: int = 6) -> str:
    """The ``n`` kernels that took the most device time a call."""
    top = sorted(m["us_by_kernel"].items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{us:.2f} us {name}" for name, us in top)


def _fmt(m: dict) -> str:
    dev = "not measured" if m["device_ms"] is None else f"{m['device_ms'] * 1e3:.2f} us"
    return (f"device {dev} in {m['launches']:.0f} device ops, "
            f"wall {m['wall_ms'] * 1e3:.2f} us")


def _mean(runs: dict, keys, field):
    vals = [runs[k][field] for k in keys]
    return None if None in vals else sum(vals) / len(vals)


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _k1_runs(table, offsets, batches, cdt) -> dict:
    """K1 and its plain version on each batch's ids, in the order plain,
    kernel, kernel, plain, so drift over the run hits both alike."""
    def k1(idx):
        return embedding_bag(table, offsets, idx, compute_dtype=cdt)

    def plain(idx):
        return embedding_bag_reference(table, offsets, idx, compute_dtype=cdt)

    ids = [(b.indices,) for b in batches]
    runs = {key: measure(fn, ids, TIMED_ITERS) for key, fn in
            (("p1", plain), ("k1", k1), ("k2", k1), ("p2", plain))}
    runs["s1"] = measure(k1_library(table, offsets), ids, TIMED_ITERS)
    return runs


def _k1_summary(runs: dict, batches, table, offsets) -> dict:
    """K1's times (device where the trace has them, else wall) beside its
    bound on the first batch's ids and the library call's time."""
    B, T, L = batches[0].indices.shape
    d = table.shape[1]
    # The kernel runs: the median kernel, which a trace that dropped events
    # cannot pull down as it can the sum a call.
    k_dev, p_dev = _mean(runs, ("k1", "k2"), "kernel_ms"), _mean(runs, ("p1", "p2"), "device_ms")
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    n_rows = B * T * L
    bound = k1_bound(table, offsets, batches[0].indices, torch.bfloat16)
    use_dev = k_dev is not None and p_dev is not None and runs["s1"]["device_ms"] is not None
    k_ms = k_dev if use_dev else k_wall
    p_ms = p_dev if use_dev else p_wall
    lib_ms = runs["s1"]["device_ms"] if use_dev else runs["s1"]["wall_ms"]
    return {"shape": f"B={B} T={T} L={L} d={d}", "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "device": use_dev, "k_wall": k_wall, "p_wall": p_wall,
            "p_dev": p_dev, "bytes": bound["bytes"], "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "rows_per_s": n_rows / (k_ms / 1e3),
            "hbm_share": bound["bytes"] / (k_ms / 1e3) / HBM_BYTES_PER_S}


def _k1_line(s: dict, name: str, card: str) -> str:
    return (f"K1 {name} shape ({s['shape']}, {s['bytes'] / 1e6:.2f} MB moved): "
            f"{s['ms'] * 1e3:.2f} us ({'device' if s['device'] else 'wall'}), "
            f"{s['rows_per_s'] / 1e9:.3f} G rows/s, "
            f"{s['bytes'] / (s['ms'] / 1e3) / 1e9:.1f} GB/s = "
            f"{100 * s['hbm_share']:.1f}% of 3.35 TB/s; bound {s['bound_ms'] * 1e3:.2f} us "
            f"({s['bound_by']}); F.embedding_bag {s['library_ms'] * 1e3:.2f} us; wall per call "
            f"{s['k_wall'] * 1e3:.2f} us; plain version device {_us(s['p_dev'])}, "
            f"wall {s['p_wall'] * 1e3:.2f} us [{card}]")


def phase_times(device, fwd: dict, card: str) -> dict:
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    table = params["tables"]
    offsets = table_offsets(cfg, device)
    # Eight different batches (8 x 21 MB of rows > the 50 MB L2), so the
    # timed loop reads cold rows as a real stream would.
    data = RecDataGenerator(cfg, seed=3)
    batches = [b.to(device) for b in data.generate_batches(8, BATCH)]
    bf16 = torch.bfloat16
    B, T, L = batches[0].indices.shape

    def fwd_kernel(b):
        return model.apply(params, b)

    def fwd_plain(b):
        pooled = embedding_bag_reference(table, offsets, b.indices, compute_dtype=bf16)
        return model.apply_from_pooled(params, pooled, b)

    with torch.inference_mode():
        runs = _k1_runs(table, offsets, batches, bf16)
        bs = [(b,) for b in batches]
        for key, fn, args in (("fp1", fwd_plain, bs), ("fk1", fwd_kernel, bs),
                              ("fk2", fwd_kernel, bs), ("fp2", fwd_plain, bs)):
            runs[key] = measure(fn, args, TIMED_ITERS)

    k1 = _k1_summary(runs, batches, table, offsets)
    fk_wall, fp_wall = _mean(runs, ("fk1", "fk2"), "wall_ms"), _mean(runs, ("fp1", "fp2"), "wall_ms")
    fk_dev = _mean(runs, ("fk1", "fk2"), "device_ms")
    peak = torch.cuda.max_memory_allocated(device)
    _log(f"[7 times] card: {card}; {TIMED_ITERS} calls a run, runs in the order "
         "plain, kernel, kernel, plain")
    for key in ("p1", "k1", "k2", "p2", "s1", "fp1", "fk1", "fk2", "fp2"):
        _log(f"[7 times]   {key}: {_fmt(runs[key])} [{card}]; {', '.join(runs[key]['kernels'])}")
    _log(f"[7 times] {_k1_line(k1, 'rm1', card)}")
    _log(f"[7 times] rm1 forward, device time by kernel: {_top(runs['fk1'])} [{card}]")
    idle = "not measured" if fk_dev is None else f"{100 * (1 - fk_dev / fk_wall):.1f}%"
    _log(f"[7 times] rm1 forward batch {B} bf16: kernel path {fk_wall:.4f} ms = "
         f"{B / (fk_wall / 1e3):.0f} samples/s (device {_us(fk_dev)}, idle {idle}); "
         f"plain path {fp_wall:.4f} ms = {B / (fp_wall / 1e3):.0f} samples/s [{card}]")
    _log(f"[7 times] peak device memory (phase 7): {peak / 2**30:.3f} GiB [{card}]")
    return {"k1": k1,
            "fwd_wall_ms": fk_wall, "fwd_device_ms": fk_dev, "peak_bytes": peak}


def _tail_on_cpu(model, params: dict, pooled: torch.Tensor, batch: Batch) -> torch.Tensor:
    """The model after its lookup, on the CPU: there every kernel wrapper
    takes its plain version (dien's scans the plain loop)."""
    cpu = {k: bridge.tree_map(lambda t: t.cpu(), v) for k, v in params.items() if k != "tables"}
    return model.apply_from_pooled(cpu, pooled.cpu(), batch.to("cpu"))


def zoo_forward(device, name: str, table_quant: str = "none", phase: str = "8 zoo") -> dict:
    """``name`` at full width, bf16, batch 512 (``table_quant``: int8
    tables): three forwards through ``get_model(...).apply`` with the launch
    counts read around them, the scores checked, and each forward held
    against the plain path (the plain lookup, then the rest of the model on
    the CPU). Returns the model and its state for ``zoo_times``."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=table_quant)
    t0 = time.perf_counter()
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    synchronize(device)
    init_s = time.perf_counter() - t0
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=1).generate_batches(3, BATCH)]
    want = _want(**{LOOKUP[table_quant]: len(batches)},
                 rnn_scan=2 * len(batches) if cfg.model_type == "dien" else 0)
    with torch.inference_mode():
        _reset_counts()
        outs = [model.apply(params, b) for b in batches]
        synchronize(device)
        counts = _counts()
        if counts != want:
            raise AssertionError(f"{name}: kernel launches {counts}, expected {want} "
                                 f"for {len(batches)} forwards")
        offsets = table_offsets(cfg, device)
        worst, limit = 0.0, 0.0
        for b, out in zip(batches, outs):
            _check_scores(out, (BATCH, cfg.out_dim), sigmoid_output(cfg), f"{name} forward")
            pooled = _plain_pooled(params["tables"], offsets, b.indices, torch.bfloat16)
            plain = _tail_on_cpu(model, params, pooled, b).float()
            limit = max(limit, bf16_atol(plain.numpy()))
            worst = max(worst, (out.float().cpu() - plain).abs().max().item())
        if worst > limit:
            raise AssertionError(f"{name} forward differs from its plain path: "
                                 f"{worst:.3e} > {limit:.3e}")
    nbytes = _table_bytes(params["tables"])
    layout = "bf16" if table_quant == "none" else table_quant
    _log(f"[{phase}] {name} table_scale={TABLE_SCALE} ({cfg.total_rows} x "
         f"{cfg.sparse_feature_size} {layout} table, {nbytes / 1e9:.3f} GB, init {init_s:.2f} s) "
         f"batch {BATCH}: {len(batches)} forwards, launches {counts}, scores "
         f"{tuple(outs[0].shape)} finite {'in [0, 1]' if sigmoid_output(cfg) else '>= 0'}, "
         f"max |kernel - plain path| {worst:.3e} (limit {limit:.3e})")
    return {"name": name, "cfg": cfg, "model": model, "params": params,
            "launches": counts}


def zoo_times(device, z: dict, card: str) -> dict:
    """The forward's wall and device time and idle share, K1 and its plain
    version at the model's shape, over eight batches."""
    cfg, model, params = z["cfg"], z["model"], z["params"]
    table, offsets = params["tables"], table_offsets(cfg, device)
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
    with torch.inference_mode():
        runs = _k1_runs(table, offsets, batches, torch.bfloat16)
        for key in ("fk1", "fk2"):
            runs[key] = measure(lambda b: model.apply(params, b), [(b,) for b in batches],
                                TIMED_ITERS)
    k1 = _k1_summary(runs, batches, table, offsets)
    wall, dev = _mean(runs, ("fk1", "fk2"), "wall_ms"), _mean(runs, ("fk1", "fk2"), "device_ms")
    idle = None if dev is None else 1 - dev / wall
    peak = torch.cuda.max_memory_allocated(device)
    name = z["name"]
    for key in ("p1", "k1", "k2", "p2", "s1", "fk1", "fk2"):
        _log(f"[8 zoo]   {name} {key}: {_fmt(runs[key])} [{card}]")
    _log(f"[8 zoo] {name} {_k1_line(k1, name, card)}")
    _log(f"[8 zoo] {name} forward, device time by kernel: {_top(runs['fk1'])} [{card}]")
    _log(f"[8 zoo] {name} forward batch {BATCH} bf16: wall {wall:.4f} ms = "
         f"{BATCH / (wall / 1e3):.0f} samples/s, device {_us(dev)} in "
         f"{runs['fk1']['launches']:.0f} device ops, idle "
         f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; peak device "
         f"memory {peak / 2**30:.3f} GiB [{card}]")
    return {"name": name, "fwd_wall_ms": wall, "fwd_device_ms": dev, "idle": idle,
            "k1": k1, "peak_bytes": peak, "device_ops": runs["fk1"]["launches"]}


def phase_zoo(device, card: str, on_model=None) -> tuple[list, dict]:
    """Each zoo model but rm1 at full width, its table freed before the
    next; then dien through main.py's loop. ``on_model(z)``: a path of
    another phase run on each model while it lives (phase 16's meshes),
    its launches its own. Returns the per-model times and the summed launch
    counts of these paths."""
    rows, launches = [], _want()
    for name in ZOO:
        torch.cuda.reset_peak_memory_stats(device)
        z = zoo_forward(device, name)
        _add(launches, z["launches"])
        rows.append(zoo_times(device, z, card))
        if on_model is not None:
            on_model(z)
        del z
        torch.cuda.empty_cache()

    _reset_counts()
    res = port_main.main(["--model", "dien", "--param_dtype", "bfloat16",
                          "--mini_batch_size", str(BATCH), "--num_batches", "2",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    counts = _counts()
    if counts != _want(embedding_bag=res["forwards"], rnn_scan=2 * res["forwards"]):
        raise AssertionError(f"main.py's dien loop: launches {counts} for "
                             f"{res['forwards']} forwards")
    for out in res["outputs"]:
        _check_scores(out, (BATCH, zoo.get_config("dien").out_dim), False,
                      "main.py dien forward")
    _add(launches, counts)
    _log(f"[8 zoo] main.py standalone loop, dien (no dense input): {res['forwards']} "
         f"forwards, launches {counts}, compute {res['compute_ms']:.3f} ms for 2 batches")
    torch.cuda.empty_cache()
    return rows, launches


def phase_rnn_times(device, card: str, H: int = KERNEL_HIDDEN, label: str = "9 K3 times") -> dict:
    """K3 against its plain loop at DIEN's shape (hidden size H), bf16, in
    the order plain, kernel, kernel, plain; then cuDNN's tanh RNN on the
    same recurrence (kernel_bench.k3_library), and K3's bound."""
    inp = rnn_inputs(device, DIEN_T, BATCH, torch.bfloat16, seed=1, H=H)
    args = [(inp["xproj"], inp["h2h_w"], inp["h2h_b"], torch.bfloat16)]
    iters = 50
    with torch.inference_mode():
        runs = {key: measure(fn, args, iters) for key, fn in (
            ("p1", rnn_scan_reference), ("k1", rnn_scan), ("k2", rnn_scan),
            ("p2", rnn_scan_reference))}
        runs["s1"] = measure(k3_library(inp["h2h_w"], inp["h2h_b"]),
                             [(inp["xproj"].bfloat16(),)], iters)
    for key in ("p1", "k1", "k2", "p2", "s1"):
        _log(f"[{label}]   {key}: {_fmt(runs[key])} [{card}]")
    k_dev, p_dev = _mean(runs, ("k1", "k2"), "kernel_ms"), _mean(runs, ("p1", "p2"), "device_ms")
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    bound = k3_bound(DIEN_T, BATCH, H, torch.bfloat16)
    use_dev = None not in (k_dev, p_dev, runs["s1"]["device_ms"])
    lib_ms = runs["s1"]["device_ms" if use_dev else "wall_ms"]
    _log(f"[{label}] K3 at T={DIEN_T} B={BATCH} H={H} bf16 ({iters} calls a "
         f"run): device {_us(k_dev)}, wall {k_wall * 1e3:.2f} us a scan; bound "
         f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); plain loop device "
         f"{_us(p_dev)}, wall {p_wall * 1e3:.2f} us; cuDNN RNN "
         f"{lib_ms * 1e3:.2f} us ({'device' if use_dev else 'wall'}) [{card}]")
    return {"ms": k_dev if use_dev else k_wall, "plain_ms": p_dev if use_dev else p_wall,
            "library_ms": lib_ms, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


# ---------------------------------------------------------------- int8 tables

def quant_rm1(device, quant: str, card: str) -> tuple[dict, dict, dict]:
    """rm1 at full width, bf16, with ``quant`` tables: three forwards through
    ``get_model(...).apply`` held against the plain path (the plain int8
    lookup, the same towers); main.py's standalone loop with
    ``--table_quant``; ``run_serving`` at the canonical point with one
    engine. Each path's launches are read around it. Returns the model's
    state for ``quant_times``, the serving result and the launches."""
    lookup = LOOKUP[quant]
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=quant)
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=1).generate_batches(3, BATCH)]
    launches = _want()
    with torch.inference_mode():
        _reset_counts()
        outs = [model.apply(params, b) for b in batches]
        synchronize(device)
        counts = _counts()
        if counts != _want(**{lookup: len(batches)}):
            raise AssertionError(f"rm1 {quant}: launches {counts} for {len(batches)} forwards")
        _add(launches, counts)
        offsets = table_offsets(cfg, device)
        worst = 0.0
        for b, out in zip(batches, outs):
            _check_scores(out, (BATCH, 1), True, f"rm1 {quant} forward")
            pooled = _plain_pooled(params["tables"], offsets, b.indices, torch.bfloat16)
            plain = model.apply_from_pooled(params, pooled, b)
            worst = max(worst, (out.float() - plain.float()).abs().max().item())
        if worst > BF16_ATOL:
            raise AssertionError(f"rm1 {quant} forward differs from its plain path: {worst:.3e}")
    _log(f"[12 int8] rm1 table_scale={TABLE_SCALE} bf16, {quant} tables "
         f"({_table_bytes(params['tables']) / 1e9:.3f} GB) batch {BATCH}: {len(batches)} "
         f"forwards, launches {counts}, scores finite in [0, 1], max |kernel - plain path| "
         f"{worst:.3e} (limit {BF16_ATOL:.3e})")

    _reset_counts()
    res = port_main.main(["--model", "rm1", "--param_dtype", "bfloat16", "--table_quant", quant,
                          "--mini_batch_size", str(BATCH), "--num_batches", "4",
                          "--table_scale", str(TABLE_SCALE), "--device", str(device)])
    counts = _counts()
    if counts != _want(**{lookup: res["forwards"]}):
        raise AssertionError(f"main.py --table_quant {quant}: launches {counts} for "
                             f"{res['forwards']} forwards")
    _add(launches, counts)
    for out in res["outputs"]:
        _check_scores(out, (BATCH, 1), True, f"main.py --table_quant {quant} forward")
    _log(f"[12 int8] main.py --table_quant {quant} standalone loop: {res['forwards']} forwards, "
         f"launches {counts}, compute {res['compute_ms']:.3f} ms for 4 batches")

    served, counts = serve_rm1(device, 1, card, table_quant=quant, phase="12 int8")
    _add(launches, counts)
    return {"cfg": cfg, "model": model, "params": params}, served, launches


def quant_times(device, state: dict, quant: str, card: str) -> dict:
    """The int8 kernel at rm1's shape (bf16 output, eight batches) beside its
    plain version (order plain, kernel, kernel, plain), its bound, and K1 on
    the same ids over a bf16 table of the same rows; then rm1's forward with
    ``quant`` tables: wall, device time, idle share, peak memory. No
    PyTorch call pools int8 rows, so the kernel has no library time."""
    cfg, model, params = state["cfg"], state["model"], state["params"]
    tables, offsets = params["tables"], table_offsets(cfg, device)
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
    ids = [(b.indices,) for b in batches]
    bf16 = torch.bfloat16
    if quant == "int8":
        def kernel(i):
            return embedding_bag_int8(tables["q"], tables["scale"], offsets, i, compute_dtype=bf16)

        def plain(i):
            return embedding_bag_int8_reference(tables["q"], tables["scale"], offsets, i,
                                                compute_dtype=bf16)
        bound = k1_int8_bound(tables["q"], offsets, batches[0].indices, bf16)
    else:
        def kernel(i):
            return embedding_bag_int8_rowwise(tables["qrows"], offsets, i, compute_dtype=bf16)

        def plain(i):
            return embedding_bag_int8_rowwise_reference(tables["qrows"], offsets, i,
                                                        compute_dtype=bf16)
        bound = k4_bound(tables["qrows"], offsets, batches[0].indices, bf16)
    with torch.inference_mode():
        runs = {key: measure(fn, ids, TIMED_ITERS) for key, fn in
                (("p1", plain), ("k1", kernel), ("k2", kernel), ("p2", plain))}
        table16 = torch.empty((cfg.total_rows, cfg.sparse_feature_size), dtype=bf16,
                              device=device).uniform_(-0.05, 0.05)
        runs["bf16"] = measure(lambda i: embedding_bag(table16, offsets, i), ids, TIMED_ITERS)
        del table16
        _free(device)
        torch.cuda.reset_peak_memory_stats(device)
        for key in ("fk1", "fk2"):
            runs[key] = measure(lambda b: model.apply(params, b), [(b,) for b in batches],
                                TIMED_ITERS)
    peak = torch.cuda.max_memory_allocated(device)
    k_dev, p_dev = _mean(runs, ("k1", "k2"), "kernel_ms"), _mean(runs, ("p1", "p2"), "device_ms")
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    use_dev = None not in (k_dev, p_dev, runs["bf16"]["kernel_ms"])
    k_ms, p_ms = (k_dev, p_dev) if use_dev else (k_wall, p_wall)
    k1_ms = runs["bf16"]["kernel_ms" if use_dev else "wall_ms"]
    wall, dev = _mean(runs, ("fk1", "fk2"), "wall_ms"), _mean(runs, ("fk1", "fk2"), "device_ms")
    idle = None if dev is None else 1 - dev / wall
    name = "K1-int8" if quant == "int8" else "K4"
    for key in ("p1", "k1", "k2", "p2", "bf16", "fk1", "fk2"):
        _log(f"[12 int8]   rm1 {quant} {key}: {_fmt(runs[key])} [{card}]")
    B, T, L = batches[0].indices.shape
    _log(f"[12 int8] {name} rm1 shape (B={B} T={T} L={L} d={cfg.sparse_feature_size}, bf16 out, "
         f"{bound['bytes'] / 1e6:.2f} MB moved): {k_ms * 1e3:.2f} us "
         f"({'device' if use_dev else 'wall'}), {B * T * L / (k_ms / 1e3) / 1e9:.3f} G rows/s, "
         f"{100 * bound['bytes'] / (k_ms / 1e3) / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s; bound "
         f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); plain version "
         f"{p_ms * 1e3:.2f} us; library: none (no PyTorch call pools int8 rows); K1 on a "
         f"bf16 table, same ids {k1_ms * 1e3:.2f} us; wall per call {k_wall * 1e3:.2f} us [{card}]")
    _log(f"[12 int8] rm1 forward batch {BATCH} bf16, {quant} tables: wall {wall:.4f} ms = "
         f"{BATCH / (wall / 1e3):.0f} samples/s, device {_us(dev)} in "
         f"{runs['fk1']['launches']:.0f} device ops, idle "
         f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; device time by kernel: "
         f"{_top(runs['fk1'])}; peak device memory {peak / 2**30:.3f} GiB [{card}]")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None, "k1_bf16_ms": k1_ms,
            "fwd_wall_ms": wall, "fwd_device_ms": dev, "idle": idle, "peak_bytes": peak}


def phase_quant(device, card: str) -> tuple[dict, dict]:
    """Phase 12: int8 tables at full width. rm1 in both modes (forwards,
    the CLI loop, serving, times), then the other seven models in
    int8_rowwise (three forwards each, held against the plain path).
    Returns the times and serving results by mode, and the launches."""
    t0 = time.perf_counter()
    launches, out = _want(), {}
    for quant in QUANT_MODES:
        state, served, counts = quant_rm1(device, quant, card)
        _add(launches, counts)
        out[quant] = {**quant_times(device, state, quant, card), "serving": served}
        del state
        _free(device)
    for name in ZOO:
        z = zoo_forward(device, name, table_quant="int8_rowwise", phase="12 int8")
        _add(launches, z["launches"])
        del z
        _free(device)
    _log(f"[12 int8] phase 12 in {time.perf_counter() - t0:.1f} s")
    return out, launches


# ---------------------------------------------------------------- hot/cold

def _device_split(device, split: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(split[k])).to(device)
            for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}


def hotcold_case(device, quant: str, inp: dict, hot_ids: np.ndarray, mask: np.ndarray | None,
                 cdt: torch.dtype, what: str) -> float:
    """K6 on ``inp``'s first batch with the hot set ``hot_ids`` (split on the
    host, natively), held to its plain version and to the direct kernel on
    the same ids: per-table int8 bit for bit, float within
    ``hotcold_tolerance``/``pooled_tolerance``, row-wise within
    ``hotcold_tolerance``/``rowwise_tolerance``; its first launch alone
    (``hotcold_cold_starts``) held to ``torch.searchsorted`` of the cold
    stream. Returns max |K6 - plain|."""
    tables, offsets, idx_host = inp["tables"], inp["offsets"], inp["streams"][0]
    index = inp["index"] if hot_ids is inp["hot_ids"] else None
    split = _device_split(device, hotcold_ops.split_hot_cold(
        idx_host, np.asarray(inp["cfg"].table_offsets, dtype=np.int64), hot_ids,
        cold_buckets=cold_buckets_for(idx_host.size), impl="native", slot_mask=mask,
        hot_index=index))
    hot = inp["rows"].index_select(0, torch.as_tensor(hot_ids, dtype=torch.int64, device=device))
    idx = inp["batches"][0][0]
    dmask = None if mask is None else torch.from_numpy(mask).to(device)
    # K6's first launch alone: each bag's cold start and the first pad.
    n_bags = idx.shape[0] * idx.shape[1]
    starts = hotcold_cold_starts(split["cold_seg"], n_bags)
    synchronize(device)
    want_starts = torch.searchsorted(split["cold_seg"], torch.arange(
        n_bags + 1, dtype=torch.int32, device=device))
    if not torch.equal(starts.long(), want_starts):
        raise AssertionError(f"K6's cold_start differs from torch.searchsorted ({what})")
    got = k6_call(quant, hot, tables, split, cdt)
    synchronize(device)
    want = k6_call(quant, hot, tables, split, cdt, plain=True)
    direct = direct_call(quant, tables, offsets, idx, cdt, mask=dmask)
    synchronize(device)
    name = {"none": "K6", "int8": "K6-int8", "int8_rowwise": "K6-rowwise"}[quant]
    if quant == "int8":
        if got.dtype != cdt or not torch.equal(got, want) or not torch.equal(got, direct):
            raise AssertionError(f"{name} differs from its plain version or K1-int8 ({what})")
        return 0.0
    rowwise = quant == "int8_rowwise"
    err = _check_pooled(got, want, hot, tables if not rowwise else tables["qrows"], split, None,
                        f"{what}, against the plain version",
                        tolerance=lambda a, b, h, t, s, _m: hotcold_tolerance(
                            a, b, h, t, s, rowwise=rowwise), kernel=name)
    table = tables["qrows"] if rowwise else tables
    _check_pooled(got, direct, table, offsets, idx, dmask, f"{what}, against the direct kernel",
                  tolerance=rowwise_tolerance if rowwise else pooled_tolerance, kernel=name)
    return err


def hotcold_kernel_cases(device, name: str, seed: int) -> dict:
    """K6 at ``name``'s full shape in the three layouts, on zipf(1.2) ids
    with the JAX hot-set rule, masked and not (bf16 output; f32 too
    unmasked); for rm1 also every id hot, no id hot (K > 0) and K = 0.
    Returns the max |K6 - plain| by kernel."""
    errs = {}
    for quant in ("none",) + QUANT_MODES:
        inp = hotcold_inputs(name, quant, device, n_batches=1, table_scale=TABLE_SCALE)
        idx_host = inp["streams"][0]
        cfg = inp["cfg"]
        mask = np.random.default_rng(seed).random(idx_host.shape) < 0.7
        flat = np.unique(idx_host.astype(np.int64)
                         + np.asarray(cfg.table_offsets, np.int64)[None, :, None])
        cases = [("zipf, JAX hot set", inp["hot_ids"], None, torch.bfloat16),
                 ("zipf, JAX hot set", inp["hot_ids"], None, torch.float32),
                 ("zipf, JAX hot set, masked", inp["hot_ids"], mask, torch.bfloat16)]
        if name == "rm1":
            absent = np.setdiff1d(np.arange(cfg.total_rows - 4096, cfg.total_rows), flat)
            cases += [("every id hot", flat, None, torch.bfloat16),
                      ("no id hot", absent, None, torch.bfloat16),
                      ("K = 0", np.empty(0, np.int64), mask, torch.bfloat16)]
        key = HOTCOLD[quant]
        for what, hot_ids, m, cdt in cases:
            what = (f"{name} {quant}: {cfg.total_rows} rows, B={BATCH} T={cfg.num_tables} "
                    f"L={cfg.num_indices_per_lookup}, {what} (K={len(hot_ids)}), out "
                    f"{str(cdt)[6:]}")
            err = hotcold_case(device, quant, inp, hot_ids, m, cdt, what)
            errs[key] = max(errs.get(key, 0.0), err)
            _log(f"[13 hotcold] {key} ok {what}: max |K6 - plain| {err:.3e}, against the "
                 f"direct kernel within its tolerance")
        del inp
        _free(device)
    return errs


def _coverage(c) -> str:
    return "not sampled (under the size floor)" if c is None else f"{c:.4f} (out of sample)"


@contextlib.contextmanager
def _engines_of_runs():
    """The engines ``run_serving`` builds inside the block (a list), so a
    run's hot-set coverage can be read from them."""
    built, orig = [], orchestrator.build_engine_pool

    def capture(*args, **kwargs):
        engines, total = orig(*args, **kwargs)
        built.extend(engines)
        return engines, total
    orchestrator.build_engine_pool = capture
    try:
        yield built
    finally:
        orchestrator.build_engine_pool = orig


def serve_hotcold(device, card: str, quant: str = "none", impl: str = "hotcold",
                  queries: int = HOTCOLD_QUERIES, cli: bool = False) -> tuple[dict, dict]:
    """rm1 (bf16, one engine) at the canonical point with ``embedding_impl=
    impl`` and ``quant`` tables, through ``run_serving`` or (``cli``)
    ``main.py --queue``: 0 errors; with "hotcold" K6 launches equal to
    executions and every served execution split by the native splitter;
    with "auto" on this uniform stream the direct kernel, no split."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", table_quant=quant, embedding_impl=impl)
    _reset_peak(device)
    _reset_counts()
    splits0 = hotcold_ops._split_hot_cold_native.calls
    with _engines_of_runs() as engines:
        if cli:
            res = port_main.main([
                "--model", "rm1", "--param_dtype", "bfloat16", "--table_scale",
                str(TABLE_SCALE), "--queue", "--engine_backend", _backend(device),
                "--embedding_impl", impl, "--table_quant", quant, "--num_batches", str(queries),
                "--batch_size_distribution", "normal", "--avg_mini_batch_size", "165",
                "--var_mini_batch_size", "16", "--sub_task_batch_size", "32",
                "--avg_arrival_rate", "10"])
        else:
            scfg = ServingConfig(**SERVING_POINT, num_batches=queries,
                                 engine_backend=_backend(device))
            res = run_serving(cfg, scfg, settle_s=0.1)
    counts = _counts()
    splits = hotcold_ops._split_hot_cold_native.calls - splits0
    (eng,) = engines
    split_on = eng._hotcold is not None
    what = (f"rm1 {quant} tables, embedding_impl={impl}"
            f"{' through main.py --queue' if cli else ''}")
    if split_on != (impl == "hotcold"):
        raise AssertionError(f"{what}: the engine {'split' if split_on else 'did not split'} "
                             f"(coverage {eng.hot_coverage})")
    served = sum(res.bucket_counts.values())
    if splits != (served if split_on else 0):
        raise AssertionError(f"{what}: {splits} native splits for {served} served executions")
    _check_served(res, counts, 0, what, lookup=(HOTCOLD if split_on else LOOKUP)[quant])
    peak = _peak_gib(device)
    _log(f"[13 hotcold] {what}, 1 engine: {_served_line(res, counts)}; hot-set coverage "
         f"{_coverage(eng.hot_coverage)} ({0 if eng._hotcold is None else len(eng._hotcold.hot_ids)}"
         f" hot rows); native splits {splits}; peak device memory {peak:.3f} GiB [{card}]")
    _free(device)
    return {**res.to_dict(), "peak_gib": peak, "hot_coverage": eng.hot_coverage,
            "split": split_on}, counts


def serve_hotcold_refresh(device, card: str) -> tuple[dict, dict]:
    """Zipf(1.2) payload requests (64 rows each) through one rm1 hot/cold
    engine with refresh tracking, one at a time: its warm-up hot set, chosen
    from the uniform generator, covers little of them, so the engine must
    upgrade to the stream's head. Every payload's scores are held to
    ``model.apply`` on the direct path (bf16_atol); K6 and K1 launches add
    up to the executions (K1: the direct warm-ups refresh tracking adds)."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", embedding_impl="hotcold",
                         hot_set_rows=REFRESH_HOT_ROWS)
    model = get_model(cfg.replace(embedding_impl="xla"), device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device),
                         hotcold_refresh_interval=REFRESH_INTERVAL, hotcold_refresh_window=8)
    rng = np.random.default_rng(9)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    _reset_counts()
    splits0 = hotcold_ops._split_hot_cold_native.calls
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device=device, params=params)
    eng.start()
    ready = ready_q.get(timeout=300)
    if isinstance(ready, Exception):
        raise RuntimeError("the refreshing hot/cold engine failed during setup") from ready
    warm_cov, answered, after = eng.hot_coverage, [], 0
    while len(answered) < REFRESH_MAX_PAYLOADS and after < 2 * REFRESH_INTERVAL:
        n = len(answered)
        p = Batch(dense=rng.random((64, cfg.dense_dim), dtype=np.float32),
                  indices=zipf_stream(cfg, 64, seed=100 + n))
        req_q.put(ServiceRequest(batch_id=n, batch_size=64, arrival_time=time.time(),
                                 payload=p))
        answered.append((p, resp_q.get(timeout=120)))
        after += eng.hot_refreshes > 0
    req_q.put(None)
    eng.join(timeout=120)
    counts = _counts()  # before the direct model's reference launches
    worst = 0.0
    with torch.inference_mode():
        for n, (p, r) in enumerate(answered):
            want = model.apply(params, p.to(device)).float().cpu().numpy()
            if r.error_code != ERR_OK or r.scores is None or r.scores.shape != want.shape:
                raise AssertionError(f"refresh payload {n}: error {r.error_code}")
            err = float(np.abs(r.scores - want).max())
            if err > bf16_atol(want):
                raise AssertionError(f"refresh payload {n}: scores differ from the direct "
                                     f"model by {err:.3e} > {bf16_atol(want):.3e}")
            worst = max(worst, err)
    n = len(answered)
    splits = hotcold_ops._split_hot_cold_native.calls - splits0
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    k6, k1 = counts["embedding_bag_hotcold"], counts["embedding_bag"]
    if eng.error is not None or eng.hot_refreshes < 1:
        raise AssertionError(f"refreshing engine: {eng.hot_refreshes} refreshes, error "
                             f"{eng.error!r}")
    if k6 + k1 != executions or k6 == 0 or counts != _want(embedding_bag_hotcold=k6,
                                                          embedding_bag=k1):
        raise AssertionError(f"refreshing engine: launches {counts} for {executions} executions")
    if splits < sum(eng.bucket_counts.values()):
        raise AssertionError(f"refreshing engine: {splits} native splits for "
                             f"{sum(eng.bucket_counts.values())} served executions")
    _log(f"[13 hotcold] rm1 hot/cold engine with refresh (interval {REFRESH_INTERVAL}, window 8): "
         f"{n} zipf(1.2) payloads of 64 rows, one at a time; warm-up coverage {warm_cov:.4f}, "
         f"hot_refreshes {eng.hot_refreshes}, hot_coverage {eng.hot_coverage:.4f}, "
         f"live_hot_coverage {eng.live_hot_coverage:.4f}; every payload's scores match "
         f"model.apply on the direct path (max |err| {worst:.3e}, limit bf16_atol); launches "
         f"{counts} for {executions} executions; native splits {splits} [{card}]")
    del params
    _free(device)
    return {"payloads": n, "hot_refreshes": eng.hot_refreshes,
            "warm_coverage": warm_cov, "hot_coverage": eng.hot_coverage,
            "live_hot_coverage": eng.live_hot_coverage, "max_abs_err": worst}, counts


def phase_hotcold(device, card: str) -> tuple[dict, dict]:
    """Phase 13, hot/cold serving: K6's cases at rm1's, rm2's and din's full
    shapes, then the serving paths, each read around itself: rm1 through
    run_serving with embedding_impl="hotcold", a refreshing engine on zipf
    payloads, "auto" on the uniform stream, and main.py --queue with
    int8_rowwise and int8 tables. Returns K6's errors, the serving results
    and the launches."""
    t0 = time.perf_counter()
    if not native_available():
        raise AssertionError("the native splitter did not build")
    errs = {}
    for seed, name in enumerate(HOTCOLD_MODELS):
        for k, v in hotcold_kernel_cases(device, name, seed).items():
            errs[k] = max(errs.get(k, 0.0), v)
    launches, out = _want(), {}
    for key, run in (
            ("hotcold", lambda: serve_hotcold(device, card)),
            ("refresh", lambda: serve_hotcold_refresh(device, card)),
            ("auto", lambda: serve_hotcold(device, card, impl="auto",
                                           queries=HOTCOLD_CLI_QUERIES)),
            ("int8_rowwise", lambda: serve_hotcold(device, card, quant="int8_rowwise",
                                                   queries=HOTCOLD_CLI_QUERIES, cli=True)),
            ("int8", lambda: serve_hotcold(device, card, quant="int8",
                                           queries=HOTCOLD_CLI_QUERIES, cli=True))):
        out[key], counts = run()
        _add(launches, counts)
    _log(f"[13 hotcold] cases and serving paths in {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "serving": out}, launches


def hotcold_times(device, card: str) -> dict:
    """K6 in the three layouts at rm1's shape (bf16 output, eight zipf(1.2)
    batches with the JAX hot set) beside its plain version (order plain,
    kernel, kernel, plain), its bound, the direct kernel on the same ids
    and, for the float table, ``F.embedding_bag`` on the original ids. K6's
    time is the sum of its two launches (``cold_start``, then the pool;
    ``kernel_bench.launch_sum_ms``), its bound the function's
    (``kernel_bench.k6_bound``); its span (``kernel_bench.span_ms``,
    launches that overlap counted once) stands beside the direct kernel's,
    and on a line of its own the ``cold_start`` launch's time beside that
    launch's bound (``kernel_bench.cold_starts_bound``)."""
    out = {}
    with torch.inference_mode():
        for quant in ("none",) + QUANT_MODES:
            inp = hotcold_inputs("rm1", quant, device, table_scale=TABLE_SCALE)
            calls = hotcold_calls(inp, quant)
            args = inp["batches"]
            runs = {key: measure(fn, args, TIMED_ITERS) for key, fn in
                    (("p1", calls["plain"]), ("k1", calls["kernel"]), ("k2", calls["kernel"]),
                     ("p2", calls["plain"]), ("direct", calls["direct"]))}
            if calls["library"] is not None:
                runs["s1"] = measure(calls["library"], args, TIMED_ITERS)
            bound = calls["bound"](*args[0])
            starts_bound = cold_starts_bound(args[0][1])
            starts = [named_kernel_ms(runs[k], "cold_starts") for k in ("k1", "k2")]
            starts_ms = None if None in starts else sum(starts) / 2
            k_dev, p_dev = _mean(runs, ("k1", "k2"), "launch_sum_ms"), _mean(runs, ("p1", "p2"),
                                                                             "device_ms")
            use_dev = None not in (k_dev, p_dev, runs["direct"]["kernel_ms"])
            lib = runs.get("s1")
            r = {"ms": k_dev if use_dev else _mean(runs, ("k1", "k2"), "wall_ms"),
                 "plain_ms": p_dev if use_dev else _mean(runs, ("p1", "p2"), "wall_ms"),
                 "library_ms": None if lib is None else lib["device_ms" if use_dev else "wall_ms"],
                 "direct_ms": runs["direct"]["kernel_ms" if use_dev else "wall_ms"],
                 "span_ms": span_ms(calls["kernel"], args),
                 "direct_span_ms": span_ms(calls["direct"], args),
                 "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                 "cold_starts_ms": starts_ms, "cold_starts_bound_ms": starts_bound["bound_ms"],
                 "coverage": inp["coverage"]}
            out[HOTCOLD[quant]] = r
            B, T, L = args[0][0].shape
            _log(f"[13 hotcold times] {HOTCOLD[quant]} rm1 shape (B={B} T={T} L={L}, bf16 out, "
                 f"zipf(1.2), {inp['hot_rows']} hot rows, coverage {inp['coverage']:.4f}, "
                 f"{bound['bytes'] / 1e6:.2f} MB moved): {r['ms'] * 1e3:.2f} us "
                 f"({'device, both launches' if use_dev else 'wall'}: "
                 f"{_top(runs['k1'], 2)}); span {r['span_ms'] * 1e3:.2f} us (direct "
                 f"{r['direct_span_ms'] * 1e3:.2f}); bound {r['bound_ms'] * 1e3:.2f} us "
                 f"({r['bound_by']}); plain {r['plain_ms'] * 1e3:.2f} us; direct kernel on the "
                 f"same ids {r['direct_ms'] * 1e3:.2f} us; library "
                 f"{'none (no PyTorch call pools int8 rows)' if lib is None else _us(r['library_ms']) + ' (F.embedding_bag, original ids)'} "
                 f"[{card}]")
            _log(f"[13 hotcold times] {HOTCOLD[quant]} rm1 shape, its cold_start launch: "
                 f"{_us(starts_ms)} (device, median); bound {_us(starts_bound['bound_ms'])} "
                 f"({starts_bound['bytes'] / 1e6:.3f} MB: cold_seg read, cold_start written) "
                 f"[{card}]")
            del inp, calls, args
            _free(device)
    return out


def phase_skew(device, card: str) -> list:
    """``experiments.skew_bench.measure_skewed`` for rm1, rm2 and din, each
    model's table freed before the next."""
    rows = []
    for name in HOTCOLD_MODELS:
        rows.append(measure_skewed(name, device, table_scale=TABLE_SCALE))
        _log(f"[13 skew] {skew_line(rows[-1], card)}")
        _free(device)
    return rows


# ---------------------------------------------------------------- training

def _train_inputs(device, name: str, seed: int):
    """``name``'s training-batch ids (the generator's, batch TRAIN_BATCH) and
    offsets at TABLE_SCALE, and a generator for the rest."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
    indices = torch.as_tensor(
        RecDataGenerator(cfg, seed=seed).generate_batch(TRAIN_BATCH).indices).to(device)
    return cfg, table_offsets(cfg, device), indices, torch.Generator(device=device).manual_seed(seed)


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_kernel_cases(device, name: str, seed: int) -> dict:
    """K1b and K5 against their plain versions at ``name``'s training shape
    (full-size table, batch TRAIN_BATCH, the generator's ids): K1b with f32
    and bf16 gradients, with and without a mask, K5 with f32 and bf16
    tables, on the generator's ids and on ids folded onto DUP_ROWS rows a
    table; each within its tolerance of the order of a row's adds. Returns
    the max |error| by kernel."""
    cfg, offsets, indices, g = _train_inputs(device, name, seed)
    R, T, d = cfg.total_rows, cfg.num_tables, cfg.sparse_feature_size
    B, _, L = indices.shape
    mask = torch.rand(indices.shape, generator=g, device=device) < 0.7
    errs = {"embedding_bag_backward": 0.0, "sparse_adagrad_step": 0.0}
    shape = f"{name}: R={R} d={d} B={B} T={T} L={L}"
    for gdt in (torch.float32, torch.bfloat16):
        grad = torch.randn((B, T, d), generator=g, device=device).to(gdt)
        for m in (None, mask):
            got = embedding_bag_backward(grad, offsets, indices, R, mask=m)
            synchronize(device)
            err = (got - embedding_bag_backward_reference(grad, offsets, indices, R, mask=m)).abs()
            del got
            tol = backward_tolerance(grad, offsets, indices, R, m)
            what = f"{shape}, g {str(gdt)[6:]}, mask={'yes' if m is not None else 'no'}"
            if not bool((err <= tol).all()):
                raise AssertionError(f"K1b disagrees with its plain version ({what}): max |err| "
                                     f"{err.max().item():.3e}, {int((err > tol).sum())} over")
            errs["embedding_bag_backward"] = max(errs["embedding_bag_backward"], err.max().item())
            _log(f"[11 train kernels] K1b ok {what}: max |err| {err.max().item():.3e} "
                 f"(limit: the order of each row's adds)")
            del err, tol
            _free(device)
    grad = torch.randn((B, T, d), generator=g, device=device) * 1e-2
    # The generator's ids, and the same bags on DUP_ROWS rows a table, so
    # that each row takes many adds in one step.
    dup = indices % DUP_ROWS
    for tdt, ids in ((torch.float32, indices), (torch.bfloat16, indices),
                     (torch.float32, dup), (torch.bfloat16, dup)):
        table0 = ((torch.rand((R, d), generator=g, device=device) - 0.5) * 0.1).to(tdt)
        acc0 = torch.rand((R,), generator=g, device=device) * 1e-4
        table, acc = table0.clone(), acc0.clone()
        sparse_adagrad_step(table, acc, offsets, ids, grad, 0.1)
        synchronize(device)
        want_t, want_a = table0.clone(), acc0.clone()
        sparse_adagrad_step_reference(want_t, want_a, offsets, ids, grad, 0.1)
        tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, ids, grad, 0.1)
        del table0, acc0
        err = (table.float() - want_t.float()).abs()
        acc_err = (acc - want_a).abs()
        what = (f"{shape}, table {str(tdt)[6:]}"
                + (f", ids on {DUP_ROWS} rows a table" if ids is dup else ""))
        if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
            raise AssertionError(f"K5 disagrees with its plain version ({what}): max |err| "
                                 f"table {err.max().item():.3e}, acc {acc_err.max().item():.3e}")
        errs["sparse_adagrad_step"] = max(errs["sparse_adagrad_step"], err.max().item(),
                                          acc_err.max().item())
        _log(f"[11 train kernels] K5 ok {what}: max |err| table {err.max().item():.3e}, "
             f"accumulator {acc_err.max().item():.3e}")
        del table, acc, want_t, want_a, tol, acc_tol, err, acc_err
        _free(device)
    return errs


def _k10_step(device, name: str, params: list, grads: list, states: list, count: int) -> float:
    """One step of K10 on copies and of the plain version in place, from
    the same values; raises unless every param and state element is the
    same bit for bit. Returns the max |difference| (0.0). ``count``: adam's
    step count, handed to both as the int32 scalar on the card the trainer
    keeps."""
    count = torch.tensor(count, dtype=torch.int32, device=device)
    ps, ss = [p.clone() for p in params], [[t.clone() for t in s] for s in states]
    optimizer_update(name, ps, grads, ss, 0.1, count)
    synchronize(device)
    optimizer_update_reference(name, params, grads, states, 0.1, count)
    got, want = ps + [t for s in ss for t in s], params + [t for s in states for t in s]
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K10 {name} differs from its plain version (max |diff| "
                             f"{diff:.3e}) on leaves {[tuple(p.shape) for p in params][:6]}")
    return diff


def _k10_states(name: str, params: list) -> list:
    """The trainer's initial state for ``params`` as ``optimizer_update``'s
    state lists."""
    st = port_train.make_optimizer(name, 0.1).init(params)
    return [] if st is None else [st] if name == "adagrad" else [st["mu"], st["nu"]]


def train_k10_cases(device) -> float:
    """K10 against its plain version, bit for bit, for sgd, adagrad and adam
    in f32 and bf16: steps at K10_COUNTS (adam's bias corrections from the
    count on the card: K10's powf against torch.pow)
    on leaves of K10_SIZES elements and an unaligned slice of each (4 or 2
    bytes past a 16-byte boundary: the element-by-element path), gradients
    over seven decades; then one step on rm1's params (full-size table at
    TABLE_SCALE). Returns the max |difference| (0.0)."""
    gen = torch.Generator(device=device).manual_seed(11)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for name in ("sgd", "adagrad", "adam"):
            params = [torch.randn((n,), generator=gen, device=device).to(dt) for n in K10_SIZES]
            params += [torch.randn((n + 1,), generator=gen, device=device).to(dt)[1:]
                       for n in K10_SIZES]
            grads = [(torch.randn(p.shape, generator=gen, device=device)
                      * 10.0 ** torch.randint(-6, 1, p.shape, generator=gen, device=device)).to(dt)
                     for p in params]
            states = _k10_states(name, params)
            for count in K10_COUNTS:
                worst = max(worst, _k10_step(device, name, params, grads, states, count))
            _log(f"[11 train kernels] K10 ok {name} {str(dt)[6:]}: leaves of {K10_SIZES} "
                 f"elements, aligned and 1 element past a 16-byte boundary, steps at counts "
                 f"{K10_COUNTS}: bit for bit the plain version")
    for dt in (torch.float32, torch.bfloat16):
        leaves, grads = k10_inputs(device, table_scale=TABLE_SCALE)
        leaves, grads = [p.to(dt) for p in leaves], [g.to(dt) for g in grads]
        for name in ("sgd", "adagrad", "adam"):
            worst = max(worst, _k10_step(device, name, leaves, grads, _k10_states(name, leaves),
                                         1))
            _free(device)
        _log(f"[11 train kernels] K10 ok rm1's {len(leaves)} params "
             f"({sum(p.numel() for p in leaves)} elements, table_scale={TABLE_SCALE}) "
             f"{str(dt)[6:]}, sgd, adagrad and adam: bit for bit the plain version")
        del leaves, grads
        _free(device)
    return worst


def _rnn_backward_inputs(device, T: int, B: int, dtype: torch.dtype, seed: int,
                         H: int = KERNEL_HIDDEN):
    """K3b's inputs at (T, B, H): the f32 tanh values of a forward scan of
    ``rnn_inputs`` and a random gradient of every step's state."""
    inp = rnn_inputs(device, T, B, dtype, seed, H)
    w, b, h0 = inp["h2h_w"], inp["h2h_b"], inp["h0"]
    all_h, _ = rnn_scan_reference(inp["xproj"], w, b, torch.float32, h0=h0)
    prev = torch.cat([h0[None], all_h[:-1]])
    y = torch.tanh((inp["xproj"] + prev @ w.float()) + b.float())
    gh = torch.randn((T, B, H), generator=torch.Generator(device=device)
                     .manual_seed(seed), device=device)
    return y, gh, w, inp["seq_lengths"]


def train_rnn_cases(device, T: int, B: int, seed: int = 0, H: int = KERNEL_HIDDEN,
                    phase: str = "11 train kernels") -> float:
    """K3b against its plain reverse loop with f32 and bf16 weights, with
    and without seq_lengths, at hidden size H, within K3B_RTOL of the
    largest |delta|."""
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        y, gh, w, lens = _rnn_backward_inputs(device, T, B, dt, seed, H)
        for m in (None, lens):
            delta, dh0 = rnn_scan_backward(y, gh, w, m)
            synchronize(device)
            want_d, want_h = rnn_scan_backward_reference(y, gh, w, m)
            scale = max(want_d.abs().max().item(), want_h.abs().max().item())
            err = max((delta - want_d).abs().max().item(), (dh0 - want_h).abs().max().item())
            what = (f"T={T} B={B} H={H} W {str(dt)[6:]}, "
                    f"seq_lengths={'yes' if m is not None else 'no'}")
            if err > K3B_RTOL * scale:
                raise AssertionError(f"K3b disagrees with its plain loop ({what}): max |err| "
                                     f"{err:.3e} > {K3B_RTOL:.0e} x {scale:.3e}")
            worst = max(worst, err)
            _log(f"[{phase}] K3b ok {what}: max |err| {err:.3e} = "
                 f"{err / scale:.2e} of the largest |delta| (limit {K3B_RTOL:.0e})")
    return worst


def train_fixture_case(device, stored, name: str, mode: str) -> float:
    """The port's trainer from the fixture's weights on its batches: the
    losses against the JAX trainer's. Returns the max relative error."""
    key = f"{name}/{mode}/"
    cfg = zoo.get_config(name, table_scale=2000)
    np_params = bridge.init_numpy(cfg, int(stored[key + "seed"]))
    if not np.allclose(bridge.fingerprint(np_params), stored[key + "fingerprint"],
                       rtol=1e-9, atol=0):
        raise AssertionError(f"{key}: numpy drew other weights from the fixture's seed")
    tr = port_train.Trainer(cfg, optimizer="adagrad", learning_rate=float(stored[key + "lr"]),
                            sparse_tables=mode == "sparse", device=device,
                            params=bridge.params_from_numpy(np_params, cfg, device))
    indices = stored[key + "indices"]
    dense = stored[key + "dense"] if key + "dense" in stored.files else None
    gen = RecDataGenerator(tr.cfg, seed=1)
    losses = []
    for s in range(len(indices)):
        host = Batch(None if dense is None else dense[s], indices[s])
        if not np.array_equal(gen.generate_batch(indices.shape[1]).indices, indices[s]):
            raise AssertionError(f"{key}: the generator's batch {s} differs from the fixture's")
        losses.append(float(tr.step(host, tr._labels(host, None))))
    want = stored[key + "losses"]
    err = float(np.max(np.abs(np.asarray(losses) - want) / np.abs(want)))
    if not err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{key}: losses {losses} differ from JAX's {want.tolist()} "
                             f"(max relative error {err:.2e} > {TRAIN_LOSS_RTOL:.0e})")
    return err


def phase_train_fixture(device) -> float:
    stored = np.load(TRAIN_FIXTURE)
    worst = 0.0
    for name in TRAIN_FAMILIES:
        errs = {mode: train_fixture_case(device, stored, name, mode) for mode in ("dense", "sparse")}
        worst = max(worst, *errs.values())
        _log(f"[11 train fixture] {name} table_scale=2000 f32, 3 adagrad steps: losses match the "
             f"JAX trainer's, max relative error " + ", ".join(
                 f"{m} {e:.2e}" for m, e in errs.items()) + f" (limit {TRAIN_LOSS_RTOL:.0e})")
    return worst


def _train_want(name: str, sparse: bool, steps: int) -> dict:
    dien = zoo.get_config(name).model_type == "dien"
    return _want(embedding_bag=steps, embedding_bag_backward=0 if sparse else steps,
                 sparse_adagrad_step=steps if sparse else 0, optimizer_update=steps,
                 rnn_scan=2 * steps if dien else 0, rnn_scan_backward=2 * steps if dien else 0)


def train_path(device, name: str, sparse: bool, card: str) -> dict:
    """``train.main`` at full width (f32, batch TRAIN_BATCH, TRAIN_STEPS
    steps), the launches read around it: every step launches K1 once, K1b
    (dense) or K5 (sparse) once, K10 once (every param, or the sparse
    step's dense half), and for dien K3 and K3b twice. The losses
    must be finite and fall (mean of the last four below the first four)."""
    args = ["--model", name, "--table_scale", str(TABLE_SCALE), "--steps", str(TRAIN_STEPS),
            "--batch_size", str(TRAIN_BATCH), "--device", str(device)]
    args += ["--sparse_tables"] if sparse else []
    _reset_peak(device)
    _reset_counts()
    t0 = time.perf_counter()
    losses = port_train.main(args)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = _counts()
    what = f"{name} {'--sparse_tables' if sparse else 'dense'}"
    if counts != _train_want(name, sparse, len(losses)):
        raise AssertionError(f"train {what}: launches {counts} for {len(losses)} steps")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"train {what}: losses not finite and falling: {losses}")
    peak = _peak_gib(device)
    _log(f"[11 train] python -m deeprecsys_tpu_torch.train {' '.join(args)}: {len(losses)} steps, "
         f"loss {first:.4f} -> {last:.4f}, launches {counts}, {wall:.2f} s with init, peak "
         f"device memory {peak:.3f} GiB [{card}]")
    _free(device)
    return {"losses": losses, "launches": counts, "wall_s": wall, "peak_gib": peak}


def round_trip(device, card: str) -> dict:
    """Train rm1 at ROUND_TRIP_SCALE, save and export (int8_rowwise) it,
    then serve the float checkpoint through main.py --checkpoint:
    standalone (its scores are the checkpoint's params' scores, not a
    random init's) and --queue (DIEN_QUERIES queries, no errors). Then
    train it again with an int8 export and serve both int8 bundles
    (``serve_export``)."""
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "rm1_trained"
    launches = _want()
    _reset_counts()
    losses = port_train.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE),
                              "--steps", "20", "--batch_size", str(TRAIN_BATCH), "--device",
                              str(device), "--save", str(ckpt), "--export_quant", "int8_rowwise"])
    _add(launches, _counts())
    cfg = zoo.get_config("rm1", table_scale=ROUND_TRIP_SCALE)
    bundle = load_model_params(cfg.replace(table_quant="int8_rowwise"), f"{ckpt}_int8_rowwise")
    qrows = bundle["tables"]["qrows"]
    if qrows.shape != (cfg.total_rows, cfg.sparse_feature_size + 4) or qrows.dtype != np.int8:
        raise AssertionError(f"export bundle: qrows {qrows.shape} {qrows.dtype}")
    params = checkpoint_params(cfg, ckpt, device)
    _reset_counts()
    res = port_main.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE),
                          "--checkpoint", str(ckpt), "--device", str(device),
                          "--num_batches", "4", "--mini_batch_size", str(BATCH)])
    counts = _counts()
    if counts != _want(embedding_bag=res["forwards"]):
        raise AssertionError(f"main.py --checkpoint: launches {counts}")
    _add(launches, counts)
    model = get_model(cfg, device)
    batches = RecDataGenerator(cfg, seed=123).generate_batches(4, BATCH)
    with torch.inference_mode():
        worst = max((out.float() - model.apply(params, b.to(device)).float()).abs().max().item()
                    for out, b in zip(res["outputs"], batches))
        random_init = model.apply(model.init(torch.Generator(device=device).manual_seed(123)),
                                  batches[0].to(device))
    if worst != 0.0 or torch.equal(random_init, res["outputs"][0]):
        raise AssertionError(f"main.py --checkpoint did not score the checkpoint's params "
                             f"(max |err| {worst:.3e})")
    _log(f"[11 round trip] rm1 table_scale={ROUND_TRIP_SCALE}: train {len(losses)} steps, "
         f"loss {np.mean(losses[:4]):.4f} -> {np.mean(losses[-4:]):.4f}; --save and "
         f"--export_quant int8_rowwise (qrows {qrows.shape}) load against the configs; "
         f"main.py --checkpoint standalone scores the checkpoint's params exactly "
         f"({res['forwards']} forwards)")
    _reset_counts()
    res_q = port_main.main([
        "--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE), "--checkpoint", str(ckpt),
        "--queue", "--engine_backend", _backend(device), "--num_batches", str(DIEN_QUERIES),
        "--batch_size_distribution", "normal", "--avg_mini_batch_size", "165",
        "--var_mini_batch_size", "16", "--sub_task_batch_size", "32",
        "--avg_arrival_rate", "10"])
    counts = _counts()
    _check_served(res_q, counts, 0, "rm1 checkpoint served by main.py --queue")
    _add(launches, counts)
    _log(f"[11 round trip] main.py --checkpoint --queue: {_served_line(res_q, counts)} [{card}]")

    # The int8 exports, each from its own training run and float checkpoint.
    ckpt8 = out_dir / "rm1_trained_b"
    _reset_counts()
    port_train.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE), "--steps", "20",
                     "--batch_size", str(TRAIN_BATCH), "--device", str(device), "--save",
                     str(ckpt8), "--export_quant", "int8"])
    _add(launches, _counts())
    quant = {}
    for mode, base in (("int8_rowwise", ckpt), ("int8", ckpt8)):
        quant[mode], counts = serve_export(device, cfg, mode, base, batches, card)
        _add(launches, counts)
    for p in out_dir.glob("rm1_trained*"):
        p.unlink()
    return {"launches": launches, "queue": res_q.to_dict(), "quant": quant}


def serve_export(device, cfg, quant: str, base: Path, batches, card: str) -> tuple[dict, dict]:
    """The trainer's ``quant`` export of checkpoint ``base`` through main.py
    --checkpoint <bundle> --table_quant <quant>: standalone, its scores are
    ``model.apply``'s on ``checkpoint_params`` of the bundle exactly, and
    within QUANT_SCORE_ATOL of the float checkpoint's; --queue answers
    DIEN_QUERIES queries without an error. Returns the scores' distance
    from the float checkpoint's, the queue's result, and the launches."""
    lookup = LOOKUP[quant]
    qcfg = cfg.replace(table_quant=quant)
    bundle = f"{base}_{quant}"
    launches = _want()
    _reset_counts()
    res = port_main.main(["--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE),
                          "--checkpoint", bundle, "--table_quant", quant, "--device", str(device),
                          "--num_batches", "4", "--mini_batch_size", str(BATCH)])
    counts = _counts()
    if counts != _want(**{lookup: res["forwards"]}):
        raise AssertionError(f"main.py --checkpoint {quant} bundle: launches {counts}")
    _add(launches, counts)
    qparams = checkpoint_params(qcfg, bundle, device)
    fparams = checkpoint_params(cfg, base, device)
    with torch.inference_mode():
        exact = max((out.float() - get_model(qcfg, device).apply(qparams, b.to(device)).float())
                    .abs().max().item() for out, b in zip(res["outputs"], batches))
        vs_float = max((out.float() - get_model(cfg, device).apply(fparams, b.to(device)).float())
                       .abs().max().item() for out, b in zip(res["outputs"], batches))
    if exact != 0.0 or not vs_float <= QUANT_SCORE_ATOL:
        raise AssertionError(f"main.py --checkpoint {quant} bundle: max |err| {exact:.3e} from "
                             f"the bundle's params (must be 0), {vs_float:.3e} from the float "
                             f"checkpoint's (limit {QUANT_SCORE_ATOL:.0e})")
    _log(f"[11 round trip] --export_quant {quant} bundle through main.py --checkpoint "
         f"--table_quant {quant}: {res['forwards']} forwards, launches {counts}, scores equal "
         f"the bundle's params' exactly; max |int8 - float checkpoint| {vs_float:.3e} "
         f"(limit {QUANT_SCORE_ATOL:.0e})")
    _reset_counts()
    res_q = port_main.main([
        "--model", "rm1", "--table_scale", str(ROUND_TRIP_SCALE), "--checkpoint", bundle,
        "--table_quant", quant, "--queue", "--engine_backend", _backend(device),
        "--num_batches", str(DIEN_QUERIES), "--batch_size_distribution", "normal",
        "--avg_mini_batch_size", "165", "--var_mini_batch_size", "16",
        "--sub_task_batch_size", "32", "--avg_arrival_rate", "10"])
    counts = _counts()
    _check_served(res_q, counts, 0, f"rm1 {quant} bundle served by main.py --queue",
                  lookup=lookup)
    _add(launches, counts)
    _log(f"[11 round trip] {quant} bundle through main.py --checkpoint --queue: "
         f"{_served_line(res_q, counts)} [{card}]")
    return {"vs_float": vs_float, "queue": res_q.to_dict()}, launches


def _timed(runs: dict, kernel_field: str = "kernel_ms") -> dict:
    """A kernel's times from runs in the order plain, kernel, kernel, plain
    and a library run: device times where the trace has them, else wall."""
    k_dev = _mean(runs, ("k1", "k2"), kernel_field)
    p_dev = _mean(runs, ("p1", "p2"), "device_ms")
    use_dev = None not in (k_dev, p_dev, runs["s1"]["device_ms"])
    k_wall, p_wall = _mean(runs, ("k1", "k2"), "wall_ms"), _mean(runs, ("p1", "p2"), "wall_ms")
    return {"ms": k_dev if use_dev else k_wall, "plain_ms": p_dev if use_dev else p_wall,
            "library_ms": runs["s1"]["device_ms" if use_dev else "wall_ms"],
            "device": use_dev, "k_wall": k_wall, "p_wall": p_wall,
            "by_kernel": _top(runs["k1"], 3)}


def _time_runs(kernel, plain, library, args, lib_args, iters) -> dict:
    runs = {key: measure(fn, args, iters) for key, fn in
            (("p1", plain), ("k1", kernel), ("k2", kernel), ("p2", plain))}
    runs["s1"] = measure(library, lib_args, iters)
    return runs


def train_kernel_times(device, card: str) -> dict:
    """K1b and K5 at rm1's training shape (full-size f32 table, batch
    TRAIN_BATCH, eight batches of ids), K3b at dien's (T = 40, B =
    TRAIN_BATCH): each kernel beside its plain version (order plain,
    kernel, kernel, plain), its bound and its library yardstick. K1b and
    its yardsticks accumulate into one preallocated f32 gradient (the
    zero-fill of a step is the same for all, and shows in the step's
    breakdown)."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    offsets = table_offsets(cfg, device)
    gen = torch.Generator(device=device).manual_seed(5)
    ids = [b.to(device).indices for b in
           RecDataGenerator(cfg, seed=3).generate_batches(8, TRAIN_BATCH)]
    gs = [torch.randn((TRAIN_BATCH, cfg.num_tables, d), generator=gen, device=device) * 1e-2
          for _ in ids]
    prepared = [g_rows(g, offsets, i) for g, i in zip(gs, ids)]
    out = {}
    grad = torch.zeros((R, d), dtype=torch.float32, device=device)
    runs = _time_runs(
        lambda g, i: embedding_bag_backward(g, offsets, i, R, out=grad),
        lambda g, i: embedding_bag_backward_reference(g, offsets, i, R, out=grad),
        k1b_library(grad), list(zip(gs, ids)), [(p[0], p[2]) for p in prepared], TIMED_ITERS)
    out["embedding_bag_backward"] = {**_timed(runs), **k1b_bound(gs[0], offsets, ids[0])}
    del grad
    _free(device)
    table = (torch.rand((R, d), generator=gen, device=device) - 0.5) * 0.1
    acc = torch.zeros((R,), dtype=torch.float32, device=device)
    runs.update(_time_runs(
        lambda g, i: sparse_adagrad_step(table, acc, offsets, i, g, 0.1),
        lambda g, i: sparse_adagrad_step_reference(table, acc, offsets, i, g, 0.1),
        k5_library(table, acc, 0.1), list(zip(gs, ids)), prepared, TIMED_ITERS))
    k5 = _timed(runs, "launch_sum_ms")
    # K5's launch 2 starts early and waits for launch 1 inside: its time is
    # the span from launch 1's start to launch 2's end, not their sum.
    out["sparse_adagrad_step"] = {
        **k5, **k5_bound(table, gs[0], offsets, ids[0]), "launch_sum_ms": k5["ms"],
        "ms": span_ms(lambda g, i: sparse_adagrad_step(table, acc, offsets, i, g, 0.1),
                      list(zip(gs, ids)), TIMED_ITERS)}
    del table, acc, prepared
    _free(device)
    out.update(k10_times(device, card))
    y, gh, w, _ = _rnn_backward_inputs(device, DIEN_T, TRAIN_BATCH, torch.float32, seed=6)
    inp = rnn_inputs(device, DIEN_T, TRAIN_BATCH, torch.float32, seed=6)
    runs = _time_runs(rnn_scan_backward, rnn_scan_backward_reference,
                      k3b_library(w, inp["h2h_b"], inp["xproj"]), [(y, gh, w)], [(gh,)], 50)
    out["rnn_scan_backward"] = {**_timed(runs), **k3b_bound(DIEN_T, TRAIN_BATCH, KERNEL_HIDDEN)}
    shapes = {"embedding_bag_backward": f"rm1 B={TRAIN_BATCH} T=8 L=80 d=32 f32, R={R}",
              "sparse_adagrad_step": f"rm1 B={TRAIN_BATCH} T=8 L=80 d=32 f32 table, R={R}",
              "rnn_scan_backward": f"dien T={DIEN_T} B={TRAIN_BATCH} H={KERNEL_HIDDEN} f32"}
    names = {"embedding_bag_backward": ("K1b", "index_add_"),
             "sparse_adagrad_step": ("K5 (span of both launches)", "index_add_ sequence"),
             "rnn_scan_backward": ("K3b", "cuDNN RNN backward-data")}
    _log(f"[11 train times] K5's two launches' medians summed: "
         f"{out['sparse_adagrad_step']['launch_sum_ms'] * 1e3:.2f} us (launch 2 waits inside "
         f"for launch 1) [{card}]")
    for key, t in out.items():
        if key not in names:
            continue
        label, lib = names[key]
        _log(f"[11 train times] {label} at {shapes[key]}: {t['ms'] * 1e3:.2f} us "
             f"({'device' if t['device'] else 'wall'}); bound {t['bound_ms'] * 1e3:.2f} us "
             f"({t['bound_by']}, {t['bytes'] / 1e6:.2f} MB); plain {t['plain_ms'] * 1e3:.2f} us; "
             f"{lib} {t['library_ms'] * 1e3:.2f} us; wall a call {t['k_wall'] * 1e3:.2f} us; "
             f"the kernel run's device time a call by kernel: {t['by_kernel']} [{card}]")
    return out


def k10_times(device, card: str) -> dict:
    """K10 over rm1's params (full-size f32 table at TABLE_SCALE, the dense
    step's leaves): adagrad (the trainer's) in the order plain, kernel,
    kernel, plain, beside its bound (no PyTorch call computes optax's
    adagrad: torch's divides by sqrt(acc) + eps); then sgd and adam, each
    beside its bound and one PyTorch call of the same function
    (``k10_library``). Returns the adagrad row as the kernels line takes it."""
    leaves, grads = k10_inputs(device, table_scale=TABLE_SCALE)
    row = None
    count = torch.ones((), dtype=torch.int32, device=device)
    for name in ("adagrad", "sgd", "adam"):
        states = _k10_states(name, leaves)

        def kernel():
            optimizer_update(name, leaves, grads, states, 0.1, count)

        def plain():
            optimizer_update_reference(name, leaves, grads, states, 0.1, count)
        order = (("p1", plain), ("k1", kernel), ("k2", kernel), ("p2", plain)) \
            if name == "adagrad" else (("k1", kernel), ("k2", kernel))
        runs = {key: measure(fn, [()], 10) for key, fn in order}
        lib = k10_library(name, 0.1)
        lib_ms = None if lib is None else measure(lambda: lib(leaves, grads, states), [()],
                                                  10)["device_ms"]
        t = {"ms": _mean(runs, ("k1", "k2"), "kernel_ms"), "library_ms": lib_ms,
             "k_wall": _mean(runs, ("k1", "k2"), "wall_ms"), **k10_bound(leaves, name),
             "plain_ms": _mean(runs, ("p1", "p2"), "device_ms") if "p1" in runs else None}
        _log(f"[11 train times] K10 {name} over rm1's {len(leaves)} f32 params "
             f"({sum(p.numel() for p in leaves)} elements): {_us(t['ms'])} (device, the kernel's "
             f"median); bound {_us(t['bound_ms'])} ({t['bound_by']}, {t['bytes'] / 1e9:.3f} GB, "
             f"{100 * t['bound_ms'] / t['ms']:.1f}% of it); plain {_us(t['plain_ms'])}; "
             + ("no PyTorch call computes it" if lib is None else
                f"one PyTorch call {_us(lib_ms)}")
             + f"; wall a call {_us(t['k_wall'])} [{card}]")
        if name == "adagrad":
            row = t
        del states
        _free(device)
    return {"optimizer_update": row}


class _PythonLaunches:
    """Counts the kernel launches made from Python (``_build.launch``) while
    it is entered, in all (``n``) and by card index (``by_card``): a
    replayed step makes none."""

    def __init__(self):
        self.n = 0
        self.by_card: dict = {}

    def __enter__(self):
        self._real = _build.launch

        def launch(*args):
            self.n += 1
            index = args[2].index
            self.by_card[index] = self.by_card.get(index, 0) + 1
            return self._real(*args)

        _build.launch = launch
        return self

    def __exit__(self, *exc):
        _build.launch = self._real


def _param_pairs(a, b) -> list:
    """``(key, a's tensor, b's tensor)`` for every distinct tensor of two
    trainers' params of one structure: ``bridge.flatten`` of a dict,
    ``leaf_groups`` of a mesh's ``ShardedParams`` (every copy)."""
    if isinstance(a, dict):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        return [(k, fa[k], fb[k]) for k in fa]
    return [(path, x, y) for ((path, _), xs), (_, ys) in zip(leaf_groups(a), leaf_groups(b))
            for x, y in zip(xs, ys)]


def _acc_pairs(a, b) -> list:
    """Two sparse trainers' row accumulators, shard by shard on a mesh."""
    if isinstance(a, torch.Tensor):
        return [(a, b)]
    return [(a.part(0, m), b.part(0, m)) for m in range(len(a.parts[0]))]


def check_graph_agreement(what: str, losses_g: list, losses_e: list, params_g, params_e,
                          opt: str, sparse: bool, steps: int, accs=()) -> dict:
    """The graphed arm against the eager arm after ``steps`` steps from the
    same weights on the same batches (GRAPH_* limits, written before any
    run): the losses within GRAPH_LOSS_RTOL, each param within GRAPH_PARAM_RTOL
    and its atol (GRAPH_PARAM_ATOL; adam GRAPH_ADAM_REACH of the steps' reach,
    a sparse table GRAPH_SPARSE_REACH of it), each row accumulator within
    GRAPH_ACC_RTOL of its largest value. Where the params are bf16 (a bf16
    table's sparse step) the rtol is GRAPH_BF16_RTOL and the losses'
    GRAPH_BF16_LOSS_RTOL. Returns the worst loss error and the worst param
    error as a share of its limit."""
    bf16 = any(b.dtype == torch.bfloat16 for _, _, b in _param_pairs(params_g, params_e))
    loss_rtol = GRAPH_BF16_LOSS_RTOL if bf16 else GRAPH_LOSS_RTOL
    loss_rel = float(np.max(np.abs(np.asarray(losses_g) - losses_e) / np.abs(losses_e)))
    if not (np.all(np.isfinite(losses_g)) and loss_rel <= loss_rtol):
        raise AssertionError(f"{what}: graphed losses {losses_g} against the eager {losses_e} "
                             f"(max relative error {loss_rel:.2e} > {loss_rtol:.0e})")
    reach = steps * GRAPH_LR[opt]
    share, worst = 0.0, 0.0
    for key, a, b in _param_pairs(params_g, params_e):
        atol = (GRAPH_ADAM_REACH * reach if opt == "adam" else
                GRAPH_SPARSE_REACH * reach if sparse and key == "tables" else GRAPH_PARAM_ATOL)
        rtol = GRAPH_BF16_RTOL if b.dtype == torch.bfloat16 else GRAPH_PARAM_RTOL
        diff = (a.float() - b.float()).abs_()
        worst = max(worst, diff.max().item())
        share = max(share, diff.div_(b.float().abs().mul_(rtol).add_(atol)).max().item())
        del diff
    for a, b in accs:
        lim = GRAPH_ACC_RTOL * b.max().item()
        share = max(share, (a - b).abs().max().item() / lim)
    if not share <= 1.0:
        raise AssertionError(f"{what}: graphed params differ from the eager ones past their "
                             f"limits ({share:.3f} of the limit, max |diff| {worst:.3e})")
    return {"loss_rel": loss_rel, "param_share": share, "param_max_diff": worst,
            "loss_rtol": loss_rtol}


def _arm(m: dict) -> dict:
    dev = m["device_ms"]
    return {"wall_ms": m["wall_ms"], "device_ms": dev,
            "idle": None if dev is None else 1 - dev / m["wall_ms"], "by_kernel": m["us_by_kernel"]}


def _arm_text(a: dict) -> str:
    idle = "not measured" if a["idle"] is None else f"{100 * a['idle']:.1f}%"
    return f"wall {a['wall_ms']:.4f} ms a step, device {_us(a['device_ms'])}, idle {idle}"


def _programs_text(progs) -> str:
    pool = progs.pool_bytes()
    return (f"{progs.captures} captures in {progs.capture_ms:.1f} ms, graph pool "
            f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}")


def graph_arms(device, what: str, graphed, eager, args: list, programs, opt: str, sparse: bool,
               params, accs, want: dict, timed: int, label: str, card: str) -> tuple[dict, dict]:
    """The graphed arm (``graphed(*a)``, a trainer's programs) and the eager
    arm (``eager(*a)``, the step function called directly) over ``args``
    (GRAPH_STEPS batches, one shape), each returning the step's loss
    tensor, then timed with the loss read back each step; and the graphed
    step's device span (``span_ms``: queued behind a ~1 ms spin, so that
    the host's work lies outside it) and its wall without reading the loss
    back (``wall_ms`` of back-to-back steps: the card's pace where the host
    queues ahead). The launches of each arm are read
    around it and must be ``want``; the graphed arm's steps after its first
    (the capture's) call no kernel wrapper from Python. Returns the result
    and the graphed arm's launches."""
    _reset_counts()
    with _PythonLaunches() as py:
        losses_g = [float(graphed(*args[0]))]
        first = py.n
        losses_g += [float(graphed(*a)) for a in args[1:]]
    synchronize(device)
    counts_g = _counts()
    _reset_counts()
    losses_e = [float(eager(*a)) for a in args]
    synchronize(device)
    counts_e = _counts()
    if counts_g != want or counts_e != want:
        raise AssertionError(f"{what}: launches graphed {_nonzero(counts_g)}, eager "
                             f"{_nonzero(counts_e)}, expected {_nonzero(want)}")
    if py.n != first or programs.captures != (device.type == "cuda"):
        raise AssertionError(f"{what}: {py.n - first} launches from Python over the replays, "
                             f"{programs.captures} captures")
    agree = check_graph_agreement(what, losses_g, losses_e, *params(), opt, sparse, len(args),
                                  accs())
    g = _arm(measure(lambda *a: float(graphed(*a)), args, timed))
    e = _arm(measure(lambda *a: float(eager(*a)), args, timed))
    on_card = device.type == "cuda"
    g["span_ms"] = span_ms(graphed, args, timed, spin_cycles=GRAPH_SPIN_CYCLES) if on_card else None
    g["queued_ms"] = wall_ms(graphed, args, timed) if on_card else None
    pool = programs.pool_bytes()
    _log(f"[{label}] {what}: graphed and eager arms agree over {len(args)} steps (losses max "
         f"relative {agree['loss_rel']:.2e}, limit {agree['loss_rtol']:.0e}; params "
         f"{agree['param_share']:.3f} of their limits, max |diff| {agree['param_max_diff']:.3e}); "
         f"graphed {_arm_text(g)}, device span {_us(g['span_ms'])}, a step without reading "
         f"the loss back {_us(g['queued_ms'])}; eager {_arm_text(e)}; "
         f"{_programs_text(programs)}; "
         f"launches a step {_nonzero({k: v // len(args) for k, v in counts_g.items()})} [{card}]")
    return {"name": what, "graphed": g, "eager": e, **agree, "captures": programs.captures,
            "capture_ms": programs.capture_ms, "pool_bytes": pool}, counts_g


def _summary_arms(st: dict) -> str:
    def arm(a):
        dev = "not measured" if a["device_ms"] is None else f"{a['device_ms']:.4f}"
        idle = "not measured" if a["idle"] is None else f"{100 * a['idle']:.1f}%"
        return f"{a['wall_ms']:.4f}, {dev}, {idle}"

    pool = "not measured" if st["pool_bytes"] is None else f"{st['pool_bytes'] / 2**20:.1f}"
    g = st["graphed"]
    ms = {k: "not measured" if g.get(k) is None else f"{g[k]:.4f}" for k in ("span_ms", "queued_ms")}
    return (f"{arm(g)} (span {ms['span_ms']}, loss unread {ms['queued_ms']}) / "
            f"{arm(st['eager'])}; {st['captures']}, "
            f"{st['capture_ms']:.1f}, {pool}; {st['param_share']:.3f}; {st['peak_gib']:.3f}")


def train_step_times(device, name: str, sparse: bool, opt: str, card: str) -> tuple[dict, dict]:
    """One training step of the CLI's shape (host batch to the card,
    forward, backward, update, the loss read back) at full width, in two
    arms from the same weights on the same batches: ``Trainer.step`` (its
    programs: the step captured as a CUDA graph and replayed) and the
    trainer's step function (``make_dense_step`` or
    ``make_sparse_table_step``) called directly, eagerly (``graph_arms``).
    Then, for a dense step, the two passes over the whole table inside it
    timed alone. Returns the result (both arms' wall, device time, idle
    share; captures, capture ms, pool bytes; peak memory) and the graphed
    arm's launches."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
    _free(device)
    _reset_peak(device)
    start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    kw = dict(optimizer=opt, learning_rate=GRAPH_LR[opt], sparse_tables=sparse, device=device,
              params=start)
    tr, ev = port_train.Trainer(cfg, **kw), port_train.Trainer(cfg, **kw)
    del start
    gen = RecDataGenerator(tr.cfg, seed=1)
    hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(GRAPH_STEPS)]
    args = [(h, tr._labels(h, None)) for h in hosts]
    what = f"{name} {'--sparse_tables' if sparse else 'dense'} {opt}"
    res, counts = graph_arms(
        device, f"{what}, batch {TRAIN_BATCH} f32", lambda h, lab: tr.step(h, lab),
        lambda h, lab: ev._step(ev.params, ev.opt_state, h.to(device), ev._targets(lab)),
        args, tr.step_program, opt, sparse, lambda: (tr.params, ev.params),
        lambda: _acc_pairs(tr.opt_state[1], ev.opt_state[1]) if sparse else (),
        _train_want(name, sparse, GRAPH_STEPS), TRAIN_TIMED, "11 train steps", card)
    peak = _peak_gib(device)
    del ev
    _free(device)
    _log(f"[11 train steps] {what}, graphed arm's device time by kernel: "
         f"{_top({'us_by_kernel': res['graphed']['by_kernel']}, 8)}; peak device memory of both "
         f"arms {peak:.3f} GiB [{card}]")
    if not sparse and opt == "adagrad":
        # The two passes over the whole table that the step's kernels share
        # one name with: the gradient's zero-fill and the optimizer's sweep.
        R, d = tr.params["tables"].shape
        fill = measure(lambda: torch.zeros((R, d), device=device), [()], 5)
        leaves = port_train._leaves(tr.params)
        grads = [torch.zeros_like(p) for p in leaves]
        sweep = measure(lambda: tr.tx.update(leaves, grads, tr.opt_state), [()], 5)
        # Each launch's median times its launches a call, summed (a 4 GB
        # fill may take more than one launch): a trace that drops one of the
        # 5 calls' events would pull a plain sum down by a fifth.
        _log(f"[11 train steps] {what} breakdown: the (R, d) gradient's zero-fill "
             f"{_us(fill['launch_sum_ms'])} (wall {fill['wall_ms'] * 1e3:.2f} us), adagrad's "
             f"update (K10) over every param {_us(sweep['launch_sum_ms'])} in "
             f"{sweep['launches']:.0f} device ops "
             f"(wall {sweep['wall_ms'] * 1e3:.2f} us) [{card}]")
        del grads
    del tr
    _free(device)
    return {**res, "name": what, "peak_gib": peak}, counts


def phase_train(device, card: str) -> tuple[dict, dict, list]:
    """Phase 11: the trainer. Returns the kernels' errors and times, the
    launches of the training paths and the step times."""
    t0 = time.perf_counter()
    errs = {}
    for seed, name in enumerate(("rm1", "dien")):
        for k, v in train_kernel_cases(device, name, seed).items():
            errs[k] = max(errs.get(k, 0.0), v)
    errs["rnn_scan_backward"] = max(train_rnn_cases(device, DIEN_T, TRAIN_BATCH),
                                    train_rnn_cases(device, DIEN_T, BATCH, seed=1))
    errs["optimizer_update"] = train_k10_cases(device)
    phase_train_fixture(device)
    launches = _want()
    for name, sparse in (("rm1", False), ("rm1", True), ("dien", True)):
        _add(launches, train_path(device, name, sparse, card)["launches"])
    _add(launches, round_trip(device, card)["launches"])
    times = train_kernel_times(device, card)
    steps = []
    for name, sparse, opt in GRAPH_RUNS:
        res, counts = train_step_times(device, name, sparse, opt, card)
        steps.append(res)
        _add(launches, counts)
    _log(f"[11 train] phase 11 in {time.perf_counter() - t0:.1f} s")
    return {k: {**times[k], "max_abs_err": errs[k]} for k in times}, launches, steps


# ------------------------------------------------------- 14 serving fabric

def _http(url: str, payload=None, timeout: float = 120.0):
    """(status, body) of a GET (``payload`` None) or a JSON POST; the body
    parsed when it is JSON."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        if r.headers.get_content_type() == "application/json":
            return r.status, json.loads(body)
        return r.status, body.decode()


def _body(batch: Batch) -> dict:
    """A predict body of a host batch."""
    out = {"indices": np.asarray(batch.indices).tolist()}
    if batch.dense is not None:
        out["dense"] = np.asarray(batch.dense, np.float32).tolist()
    return out


def _executions(engine) -> int:
    return sum(engine.bucket_counts.values()) + engine.warmup_executions


def _pct(ms: list) -> str:
    return f"p50 {np.percentile(ms, 50):.3f} ms, p95 {np.percentile(ms, 95):.3f} ms"


def _check_close(got, want: np.ndarray, what: str) -> float:
    got = np.asarray(got, np.float32)
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    if err > bf16_atol(want):
        raise AssertionError(f"{what}: scores differ from the direct forward by {err:.3e} > "
                             f"{bf16_atol(want):.3e} (shape {got.shape} vs {want.shape})")
    return err


def _forward(model, params, batch: Batch, device) -> np.ndarray:
    with torch.inference_mode():
        return model.apply(params, batch.to(device)).float().cpu().numpy()


def _traffic(base: str, body: dict, clients: int):
    """``clients`` threads sending ``body`` to /v1/predict until the
    returned event is set; the list collects failures, the counter answers."""
    stop, failures, answered = threading.Event(), [], [0]
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                status, _ = _http(f"{base}/v1/predict", body)
                ok = status == 200
            except Exception as e:  # a failed or dropped request is downtime
                ok, status = False, repr(e)
            with lock:
                if ok:
                    answered[0] += 1
                else:
                    failures.append(status)

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    return stop, threads, failures, answered


def _reload_under_traffic(server: ServingServer, base: str, body: dict, ckpt: Path) -> dict:
    """POST /v1/reload while FABRIC_CLIENTS clients keep sending ``body``;
    returns the handle's outcome, the requests answered and the failures."""
    stop, threads, failures, answered = _traffic(base, body, FABRIC_CLIENTS)
    try:
        while answered[0] < 4 and not failures:  # the clients are in flight
            time.sleep(0.01)
        t0 = time.perf_counter()
        status, out = _http(f"{base}/v1/reload", {"path": str(ckpt)})
        if status != 200 or out["scheduled"] != 1:
            raise AssertionError(f"POST /v1/reload answered {status} {out}")
        handle = server._reload_handles[0]
        if not handle.event.wait(timeout=300):
            raise AssertionError("the reload was not applied within 300 s")
        wall = time.perf_counter() - t0
        at_swap = _counts()
        before = answered[0]
        while answered[0] < before + 4 and not failures:  # served after the swap
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    _, st = _http(f"{base}/v1/reload")
    if failures or handle.error is not None or st["applied"] != 1 or st["failed"] != 0:
        raise AssertionError(f"reload under traffic: {len(failures)} failed requests "
                             f"{failures[:3]}, handle error {handle.error!r}, status {st}")
    return {"wall_s": wall, "answered": answered[0], "apply_ms": server.engines[0].last_reload_ms,
            "at_swap": at_swap}


def fabric_ingress(device, fwd: dict, card: str) -> tuple[dict, dict, tuple]:
    """rm1 behind the HTTP ingress on one engine (phase 5's params, ragged
    accepted): /v1/infer and /v1/predict at canonical sizes beside the same
    queries in-process, the fixture batch and a ragged batch through
    /v1/predict, the health, stats and metrics routes. Returns the results,
    the launches and (server, ingress, base) for the reload."""
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device), accept_ragged=True)
    sizes = model_batch_sizes(dataclasses.replace(scfg, num_batches=FABRIC_QUERIES),
                              np.random.default_rng(7))
    data = RecDataGenerator(cfg, seed=8)
    payloads = [data.generate_batch(int(n)) for n in sizes]
    fixture = Batch(dense=fwd["batches"][0].dense.float().cpu().numpy(),
                    indices=fwd["batches"][0].indices.cpu().numpy())
    rng = np.random.default_rng(9)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    lengths = rng.integers(0, L + 1, size=(64, T))
    values = np.concatenate([rng.integers(0, cfg.scaled_rows[t], size=int(lengths[b, t]))
                             for b in range(64) for t in range(T)])
    rag_dense = rng.random((64, cfg.dense_dim), dtype=np.float32)
    _reset_peak(device)
    _reset_counts()
    server = ServingServer(cfg, scfg, params=params)
    try:
        server.start(timeout=300)
        ing = HttpIngress(server)
    except BaseException:
        server.stop()
        raise
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        times = {k: [] for k in ("http_infer", "submit", "http_predict", "predict")}
        for n, p in zip(sizes, payloads):
            body = _body(p)
            for key, call in (
                    ("http_infer", lambda: _http(f"{base}/v1/infer", {"batch_size": int(n)})),
                    ("submit", lambda: (200, server.submit(int(n)))),
                    ("http_predict", lambda: _http(f"{base}/v1/predict", body)),
                    ("predict", lambda: (200, server.predict(p.indices, dense=p.dense)))):
                t0 = time.perf_counter()
                status, out = call()
                times[key].append((time.perf_counter() - t0) * 1000.0)
                if status != 200 or out["batch_size"] != n:
                    raise AssertionError(f"{key} of {n} rows answered {status}")
        _, fix = _http(f"{base}/v1/predict", _body(fixture))
        _, rag = _http(f"{base}/v1/predict", {"lengths": lengths.tolist(),
                                              "values": values.tolist(),
                                              "dense": rag_dense.tolist()})
        _, health = _http(f"{base}/v1/healthz")
        _, stats = _http(f"{base}/v1/stats")
        _, metrics = _http(f"{base}/metrics")
        counts = _counts()
        executions = _executions(server.engines[0])
        if counts != _want(embedding_bag=executions):
            raise AssertionError(f"ingress: launches {counts} for {executions} executions")
        if (health["status"] != "ok" or stats["completed"] != 4 * FABRIC_QUERIES + 2
                or 'drs_up{model="rm1"} 1' not in metrics):
            raise AssertionError(f"ingress routes: healthz {health}, stats {stats}")
    except BaseException:
        ing.stop()
        raise
    fix_err = _check_close(fix["scores"], _forward(model, params, fixture, device),
                           "/v1/predict of phase 5's batch")
    idx, mask = pad_csr(lengths, values, L)
    rag_err = _check_close(rag["scores"], _forward(model, params, Batch(
        dense=rag_dense, indices=idx.astype(np.int32), mask=mask), device),
        "ragged /v1/predict (the masked forward)")
    _log(f"[14 fabric] rm1 table_scale={TABLE_SCALE} bf16 behind the HTTP ingress, 1 engine "
         f"(accept_ragged): {FABRIC_QUERIES} queries of each kind at sizes ~N(165, 16) "
         f"(mean {sizes.mean():.1f} rows), one at a time: HTTP /v1/infer {_pct(times['http_infer'])}; "
         f"in-process submit {_pct(times['submit'])}; HTTP /v1/predict {_pct(times['http_predict'])}; "
         f"in-process predict {_pct(times['predict'])} [{card}]")
    _log(f"[14 fabric] /v1/predict of phase 5's {len(fixture.indices)}-row batch matches "
         f"model.apply: max |err| {fix_err:.3e}; ragged /v1/predict of 64 rows (lengths + values) "
         f"matches the masked forward: max |err| {rag_err:.3e} (limit bf16_atol); healthz, stats, "
         f"metrics answer; launches {counts} for {executions} executions (warm-up included)")
    out = {"sizes_mean": float(sizes.mean()), "fixture_err": fix_err, "ragged_err": rag_err,
           **{f"{k}_p50_ms": float(np.percentile(v, 50)) for k, v in times.items()},
           **{f"{k}_p95_ms": float(np.percentile(v, 95)) for k, v in times.items()}}
    return out, counts, (server, ing, base)


def fabric_reload(device, fwd: dict, served: tuple, ckpt: Path, new_params: dict,
                  card: str) -> tuple[dict, dict]:
    """The ingress's engine swaps to ``ckpt`` while two clients keep
    sending predicts: 0 failed requests, then the scores are the new
    params' direct forward. Then the same for a hot/cold rm1 engine, whose
    K6 launches go on after the swap. Returns the results and launches."""
    cfg, model = fwd["cfg"], fwd["model"]
    server, ing, base = served
    probe = RecDataGenerator(cfg, seed=10).generate_batch(32)
    launches = _want()
    out = {}
    try:
        _reset_peak(device)
        _reset_counts()
        ex0 = _executions(server.engines[0])
        cap0 = (server.engines[0].graph_captures, server.engines[0].capture_ms)
        r = _reload_under_traffic(server, base, _body(probe), ckpt)
        del r["at_swap"]
        r["recaptures"] = server.engines[0].graph_captures - cap0[0]
        r["recapture_ms"] = server.engines[0].capture_ms - cap0[1]
        counts = _counts()
        ex = _executions(server.engines[0]) - ex0
        if counts != _want(embedding_bag=ex):
            raise AssertionError(f"reload: launches {counts} for {ex} executions")
        _add(launches, counts)
        peak = _peak_gib(device)
        _, after = _http(f"{base}/v1/predict", _body(probe))
    finally:
        ing.stop()
    err = _check_close(after["scores"], _forward(model, new_params, probe, device),
                       "/v1/predict after the reload (the new params)")
    _log(f"[14 fabric] reload of {ckpt.name} ({_table_bytes(new_params['tables']) / 2**30:.3f} "
         f"GiB of tables) under {FABRIC_CLIENTS} clients of 32-row predicts: 0 failed of "
         f"{r['answered']} answered; applied in {r['apply_ms']:.1f} ms on the serve thread, "
         f"{r['recaptures']} graphs captured again in {r['recapture_ms']:.1f} ms of it "
         f"(request to ACK {r['wall_s'] * 1e3:.1f} ms); then the new params' scores (max |err| "
         f"{err:.3e}); peak device memory {peak:.3f} GiB; launches {counts} [{card}]")
    out["direct"] = {**r, "peak_gib": peak, "max_abs_err": err}
    _free(device)

    hc_cfg = cfg.replace(embedding_impl="hotcold")
    scfg = ServingConfig(engine_backend=_backend(device), batch_buckets=(32,),
                         max_mini_batch_size=32, sub_task_batch_size=32)
    _reset_peak(device)
    _reset_counts()
    server = ServingServer(hc_cfg, scfg, params=fwd["params"])
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        r = _reload_under_traffic(server, base, _body(probe), ckpt)
        k6_at_swap = r.pop("at_swap")["embedding_bag_hotcold"]
        _, after = _http(f"{base}/v1/predict", _body(probe))
        counts = _counts()
        eng = server.engines[0]
        ex = _executions(eng)
        if counts != _want(embedding_bag_hotcold=ex) or counts["embedding_bag_hotcold"] <= k6_at_swap:
            raise AssertionError(f"hot/cold reload: launches {counts} for {ex} executions, "
                                 f"{k6_at_swap} at the swap")
        _add(launches, counts)
        peak = _peak_gib(device)
        hot = torch.as_tensor(np.asarray(eng._hotcold.hot_ids), device=device)
        if not torch.equal(eng.params["hot_table"], eng.params["tables"].index_select(0, hot)):
            raise AssertionError("hot/cold reload: the hot table is not the new tables' hot rows")
    finally:
        ing.stop()
    err = _check_close(after["scores"], _forward(model, new_params, probe, device),
                       "hot/cold /v1/predict after the reload")
    _log(f"[14 fabric] hot/cold rm1 engine ({len(eng._hotcold.hot_ids)} hot rows), the same reload "
         f"under traffic: 0 failed of {r['answered']} answered; applied in {r['apply_ms']:.1f} ms "
         f"(hot table re-gathered from the new tables); K6 launches {k6_at_swap} at the swap, "
         f"{counts['embedding_bag_hotcold']} after; scores match the new params' direct forward "
         f"(max |err| {err:.3e}); peak device memory {peak:.3f} GiB [{card}]")
    out["hotcold"] = {**r, "peak_gib": peak, "max_abs_err": err}
    _free(device)
    return out, launches


def fabric_cpu_mp(device, card: str) -> tuple[dict, dict]:
    """run_serving with 2 CPU engine processes and the offload engine on
    ``device`` at the canonical point: big queries offload, no errors, and
    the parent's K1 launches are the offload engine's executions."""
    cfg = zoo.get_config("rm1", table_scale=FABRIC_MP_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    scfg = ServingConfig(**SERVING_POINT, num_batches=FABRIC_MP_QUERIES, engine_backend="cpu-mp",
                         inference_engines=2, model_accel=True,
                         accel_request_size_thres=FABRIC_ACCEL_THRES)
    _reset_counts()
    with _engines_of_runs() as engines:
        res = run_serving(cfg, scfg, settle_s=0.1, accel_device=device.type)
    counts = _counts()
    (accel,) = engines
    if (res.accel_requests == 0 or res.error_responses or res.engine_errors
            or res.num_responses != res.cpu_sub_requests + res.accel_requests):
        raise AssertionError(f"cpu-mp: {res.accel_requests} offloaded, {res.num_responses} "
                             f"responses for {res.cpu_sub_requests} + {res.accel_requests}, "
                             f"errors {res.error_responses} {res.engine_errors}")
    if accel.device.type != device.type or counts != _want(embedding_bag=_executions(accel)):
        raise AssertionError(f"cpu-mp: parent launches {counts} for the offload engine's "
                             f"{_executions(accel)} executions on {accel.device}")
    _log(f"[14 fabric] cpu-mp rm1 table_scale={FABRIC_MP_SCALE} bf16 (the processes build "
         f"their own CPU tables), 2 engine processes + the offload engine on {accel.device} for "
         f"queries of {FABRIC_ACCEL_THRES}+ rows: {_served_line(res, counts)}; {res.accel_requests} "
         f"offloaded [{card}]")
    return res.to_dict(), counts


def fabric_score_output(device, fwd: dict, ckpt: Path, new_params: dict,
                        card: str) -> tuple[float, dict]:
    """main.py --checkpoint --score_output: the npz holds the checkpoint's
    forward of main.py's batches."""
    cfg, model = fwd["cfg"], fwd["model"]
    npz = ckpt.parent / "scores.npz"
    _reset_counts()
    res = port_main.main(["--model", "rm1", "--param_dtype", "bfloat16", "--table_scale",
                          str(TABLE_SCALE), "--checkpoint", str(ckpt), "--num_batches", "2",
                          "--mini_batch_size", str(BATCH), "--device", str(device),
                          "--score_output", str(npz)])
    counts = _counts()
    if counts != _want(embedding_bag=res["forwards"]):
        raise AssertionError(f"--score_output: launches {counts} for {res['forwards']} forwards")
    with np.load(npz) as f:
        scores = f["scores"]
    batches = RecDataGenerator(cfg, seed=123).generate_batches(2, BATCH)  # main.py's
    want = np.concatenate([_forward(model, new_params, b, device) for b in batches])
    err = _check_close(scores, want, "main.py --score_output")
    _log(f"[14 fabric] main.py --checkpoint --score_output: {scores.shape[0]} x "
         f"{scores.shape[1]} f32 scores match the checkpoint's forward (max |err| {err:.3e}); "
         f"launches {counts} [{card}]")
    return err, counts


def phase_fabric(device, fwd: dict, card: str, on_checkpoint=None) -> tuple[dict, dict]:
    """Phase 14, the serving fabric, each path read around itself: the HTTP
    ingress on one engine, a checkpoint reload under traffic (direct and
    hot/cold), cpu-mp engine processes with the offload engine on the card,
    and offline scoring. ``on_checkpoint(ckpt, new_params)``: a path of
    another phase on the same checkpoint (phase 16's mesh reload), its
    result in ``out["on_checkpoint"]`` and its launches its own. Returns the
    results and the launches."""
    t0 = time.perf_counter()
    launches = _want()
    out = {}
    out["ingress"], counts, served = fabric_ingress(device, fwd, card)
    _add(launches, counts)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "rm1_fabric"
    try:
        new_params = fwd["model"].init(torch.Generator(device=device).manual_seed(1))
        t1 = time.perf_counter()
        save_params(ckpt, bridge.params_to_numpy(new_params, fwd["cfg"]))
        _log(f"[14 fabric] wrote a checkpoint of params from seed 1 in "
             f"{time.perf_counter() - t1:.1f} s")
        out["reload"], counts = fabric_reload(device, fwd, served, ckpt, new_params, card)
        _add(launches, counts)
        out["cpu_mp"], counts = fabric_cpu_mp(device, card)
        _add(launches, counts)
        out["score_err"], counts = fabric_score_output(device, fwd, ckpt, new_params, card)
        _add(launches, counts)
        if on_checkpoint is not None:
            out["on_checkpoint"] = on_checkpoint(ckpt, new_params)
    finally:
        served[1].stop()  # a no-op once stopped
        for f in out_dir.glob("rm1_fabric*"):
            f.unlink()
        (out_dir / "scores.npz").unlink(missing_ok=True)
        _free(device)
    _log(f"[14 fabric] phase 14 in {time.perf_counter() - t0:.1f} s")
    return out, launches


# ------------------------------------------- phase 15: data modes, experiments

def _count_path(what: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the launch counts set to 0 just before
    and read just after; returns (its result, the counts)."""
    _reset_counts()
    out = fn(*args, **kwargs)
    counts = _counts()
    _log(f"[15 data] {what}: launches {dict((k, v) for k, v in counts.items() if v)}")
    return out, counts


def _k1_cases(device, name: str, batch_sizes, what: str, param_dtype: str = "bfloat16",
              ids=None) -> float:
    """K1 held to its plain version on zoo model ``name``'s full-size
    table at each batch size of ``batch_sizes``, on the generator's ids
    (or on ``ids(cfg, b)``, a host (b, T, L) array). Returns the max
    |error|."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE, param_dtype=param_dtype,
                         compute_dtype=param_dtype)
    table = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))["tables"]
    offsets, cdt = table_offsets(cfg, device), table.dtype
    gen = RecDataGenerator(cfg, seed=3)
    err = 0.0
    with torch.inference_mode():
        for b in batch_sizes:
            idx = (gen.generate_batch(b).indices if ids is None else ids(cfg, b))
            idx = torch.as_tensor(np.asarray(idx), device=device)
            got = embedding_bag(table, offsets, idx, compute_dtype=cdt)
            want = embedding_bag_reference(table, offsets, idx, compute_dtype=cdt)
            err = max(err, _check_pooled(got, want, table, offsets, idx, None,
                                         f"{name} {param_dtype} batch {b}, {what}"))
    _log(f"[15 data] K1 ok on {name} {param_dtype} at batches {tuple(batch_sizes)} ({what}): "
         f"max |K1 - plain| {err:.3e}")
    del table
    _free(device)
    return err


def data_synthetic(device, work: Path, k1_uniform: dict, card: str) -> tuple[dict, dict]:
    """rm1 (bf16, full size) on stack-distance trace ids: a two-line
    ``sd_cumm`` written by ``data/trace.py profile`` from
    ``synthesize_zipf_distribution``, ``main.py --data_generation synthetic``
    standalone, the generator's host ms a batch, K1 on the trace ids held to
    its plain version and timed beside phase 7's uniform ids, the forward's
    wall."""
    dist = work / "sd_cumm"
    t0 = time.perf_counter()
    trace_mod.main(["profile", "--zipf-lines", str(TRACE_LINES), "--zipf-alpha",
                    str(TRACE_ALPHA), "--samples", str(TRACE_SAMPLES), "--format", "2line",
                    "--out", str(dist)])
    _log(f"[15 data] profiled a zipf({TRACE_ALPHA}) stream into {dist.name} in "
         f"{time.perf_counter() - t0:.2f} s")
    res, counts = _count_path("main.py --data_generation synthetic", port_main.main, [
        "--model", "rm1", "--param_dtype", "bfloat16", "--table_scale", str(TABLE_SCALE),
        "--data_generation", "synthetic", "--synthetic_data_trace_file", str(dist),
        "--mini_batch_size", str(BATCH), "--num_batches", str(DATA_BATCHES),
        "--device", str(device)])
    if counts != _want(embedding_bag=res["forwards"]):
        raise AssertionError(f"synthetic standalone: launches {counts}, expected K1 "
                             f"{res['forwards']}")
    for out in res["outputs"]:
        _check_scores(out, (BATCH, 1), True, "synthetic standalone")

    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    gen = RecDataGenerator(cfg, seed=1, data_generation="synthetic", trace_file=str(dist))
    t0 = time.perf_counter()
    hosts = [gen.generate_batch(BATCH)]
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hosts += [gen.generate_batch(BATCH) for _ in range(7)]
    batch_ms = (time.perf_counter() - t0) * 1e3 / 7
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    table, offsets = params["tables"], table_offsets(cfg, device)
    batches = [h.to(device) for h in hosts]
    distinct = len(np.unique(hosts[0].indices.astype(np.int64)
                             + np.asarray(cfg.table_offsets)[None, :, None]))
    with torch.inference_mode():
        got = embedding_bag(table, offsets, batches[0].indices, compute_dtype=torch.bfloat16)
        want = embedding_bag_reference(table, offsets, batches[0].indices,
                                       compute_dtype=torch.bfloat16)
        err = _check_pooled(got, want, table, offsets, batches[0].indices, None,
                            "rm1 trace ids")
        runs = _k1_runs(table, offsets, batches, torch.bfloat16)
        fwd = measure(model.apply, [(params, b) for b in batches], TIMED_ITERS)
    k1 = _k1_summary(runs, batches, table, offsets)
    _log(f"[15 data] generator, synthetic rm1 batch {BATCH}: first batch {first_ms:.1f} ms "
         f"(each table's line state made), then {batch_ms:.1f} ms a batch on the host; "
         f"{distinct} distinct rows of {BATCH * cfg.num_tables * cfg.num_indices_per_lookup} "
         f"lookups in a batch")
    _log(f"[15 data] {_k1_line(k1, 'rm1 trace ids', card)}")
    _log(f"[15 data] K1 rm1 bf16 batch {BATCH}: trace ids {k1['ms'] * 1e3:.2f} us against "
         f"uniform ids (phase 7) {k1_uniform['ms'] * 1e3:.2f} us; max |K1 - plain| {err:.3e}; "
         f"forward wall on trace ids {fwd['wall_ms']:.4f} ms (device "
         f"{_us(fwd['device_ms'])}) [{card}]")
    del params, table, batches, runs
    _free(device)
    return {"host_first_ms": first_ms, "host_batch_ms": batch_ms, "k1": k1,
            "errs": {"embedding_bag": err},
            "k1_uniform_ms": k1_uniform["ms"], "fwd_wall_ms": fwd["wall_ms"],
            "fwd_device_ms": fwd["device_ms"], "distinct_rows": distinct}, counts


def data_criteo(device, work: Path, card: str) -> tuple[dict, dict]:
    """``--model criteo`` (26 tables x 1 M x 32, bf16) on a Criteo TSV of
    CRITEO_ROWS rows through ``main.py --data_generation dataset
    --score_output``: one finite score a row of the file; K1 at L = 1 held
    to its plain version; the forward timed."""
    from deeprecsys_tpu_torch.data.criteo import criteo_model_config, write_synthetic_criteo

    tsv, scores = work / "criteo.tsv", work / "criteo_scores.npz"
    write_synthetic_criteo(tsv, num_rows=CRITEO_ROWS, seed=0)
    res, counts = _count_path("main.py --model criteo --data_generation dataset",
                              port_main.main, [
        "--model", "criteo", "--param_dtype", "bfloat16", "--table_scale", str(TABLE_SCALE),
        "--data_generation", "dataset", "--raw_data_file", str(tsv),
        "--mini_batch_size", str(BATCH), "--num_batches", str(CRITEO_ROWS // BATCH),
        "--device", str(device), "--score_output", str(scores)])
    if counts != _want(embedding_bag=res["forwards"]):
        raise AssertionError(f"criteo standalone: launches {counts}, expected K1 "
                             f"{res['forwards']}")
    with np.load(scores) as f:
        s = f["scores"]
    if s.shape != (CRITEO_ROWS, 1) or not np.isfinite(s).all() or not ((s >= 0) & (s <= 1)).all():
        raise AssertionError(f"criteo scores: shape {s.shape}, want ({CRITEO_ROWS}, 1) finite "
                             "in [0, 1]")
    cfg = criteo_model_config().replace(table_scale=TABLE_SCALE, param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    table, offsets = params["tables"], table_offsets(cfg, device)
    gen = RecDataGenerator(cfg, data_generation="dataset", raw_data_file=str(tsv))
    batches = [gen.generate_batch(BATCH).to(device) for _ in range(CRITEO_ROWS // BATCH)]
    with torch.inference_mode():
        err = 0.0
        for b in batches:
            got = embedding_bag(table, offsets, b.indices, compute_dtype=torch.bfloat16)
            want = embedding_bag_reference(table, offsets, b.indices,
                                           compute_dtype=torch.bfloat16)
            err = max(err, _check_pooled(got, want, table, offsets, b.indices, None,
                                         "criteo L = 1"))
        runs = _k1_runs(table, offsets, batches, torch.bfloat16)
        fwd = measure(model.apply, [(params, b) for b in batches], TIMED_ITERS)
    k1 = _k1_summary(runs, batches, table, offsets)
    _log(f"[15 data] criteo: {s.shape[0]} scores for {CRITEO_ROWS} file rows, finite in "
         f"[0, 1]; table {_table_bytes(table) / 1e9:.3f} GB; data loading "
         f"{res['load_ms']:.1f} ms for {CRITEO_ROWS} rows; max |K1 - plain| at L = 1 "
         f"{err:.3e}")
    _log(f"[15 data] {_k1_line(k1, 'criteo', card)}")
    _log(f"[15 data] criteo forward bf16 batch {BATCH}: wall {fwd['wall_ms']:.4f} ms (device "
         f"{_us(fwd['device_ms'])}); by kernel {_top(fwd)} [{card}]")
    del params, table, batches, runs
    _free(device)
    return {"k1": k1, "errs": {"embedding_bag": err}, "fwd_wall_ms": fwd["wall_ms"],
            "fwd_device_ms": fwd["device_ms"], "rows": int(s.shape[0])}, counts


def data_ladder_sim(device, work: Path, real_p95_ms: float, card: str) -> tuple[dict, dict]:
    """rm1's ladder (bf16, full size) swept on the card in this process into
    a temporary ``gpu_rm1.json``, and by ``experiments/sweep.py`` in a
    fresh process into another; then ``main.py --queue --engine_backend
    sim`` at the canonical point over each, its p95 beside the real
    engine's (phase 6)."""
    ladder, counts = _count_path("experiments/sweep.py rm1", sweep_mod.sweep_model, "rm1",
                                 device, sweep_mod.DEFAULT_BATCHES, TABLE_SCALE, "bfloat16")
    if counts["embedding_bag"] == 0:
        raise AssertionError("the ladder's sweep never launched K1")
    (work / "gpu_rm1.json").write_text(json.dumps(sweep_mod.ladder_json(ladder)))
    _free(device)
    fresh = work / "fresh"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "deeprecsys_tpu_torch.experiments.sweep", "--models",
                    "rm1", "--table-scale", str(TABLE_SCALE), "--device", str(device),
                    "--out-dir", str(fresh)], cwd=ROOT, check=True, timeout=600,
                   capture_output=True, text=True)
    fresh_ladder = json.loads((fresh / "gpu_rm1.json").read_text())
    for what, lad in ((f"this process ({threading.active_count()} threads alive)", ladder),
                      (f"a fresh process ({time.perf_counter() - t0:.1f} s)", fresh_ladder)):
        _log(f"[15 data] rm1 ladder in {what}, bf16, table_scale {TABLE_SCALE}, ms a "
             "forward: " + ", ".join(f"{b}: {ms:.4f}" for b, ms in
                                     zip(lad["batch_sizes"], lad["latencies_ms"]))
             + f" ({lad['device']}, {lad['power_limit']}) [{card}]")
    point = ["--batch_size_distribution", "normal", "--avg_mini_batch_size",
             str(SERVING_POINT["avg_mini_batch_size"]), "--var_mini_batch_size",
             str(SERVING_POINT["var_mini_batch_size"]), "--max_mini_batch_size",
             str(SERVING_POINT["max_mini_batch_size"]), "--sub_task_batch_size",
             str(SERVING_POINT["sub_task_batch_size"]), "--avg_arrival_rate",
             str(SERVING_POINT["avg_arrival_rate_ms"])]
    out = {"ladder": ladder, "fresh_ladder": fresh_ladder, "real_p95_ms": real_p95_ms,
           "errs": {"embedding_bag": _k1_cases(device, "rm1", sweep_mod.DEFAULT_BATCHES,
                                               "the ladder's ids")}}
    saved = latency_model.CHAR_DIR
    for key, char_dir in (("sim", work), ("sim_fresh", fresh)):
        latency_model.CHAR_DIR = char_dir
        try:
            res, sim_counts = _count_path(
                f"main.py --queue --engine_backend sim ({char_dir.name})", port_main.main, [
                    "--model", "rm1", "--param_dtype", "bfloat16", "--table_scale",
                    str(TABLE_SCALE), "--queue", "--engine_backend", "sim", "--num_batches",
                    str(SERVE_QUERIES)] + point)
        finally:
            latency_model.CHAR_DIR = saved
        if any(sim_counts.values()) or res.error_responses or res.engine_errors:
            raise AssertionError(f"sim serving launched {sim_counts} or failed "
                                 f"({res.error_responses} errors, {res.engine_errors})")
        out[f"{key}_p95_ms"], out[f"{key}_p50_ms"] = res.p95_ms, res.p50_ms
        _log(f"[15 data] rm1 at the canonical point, 1 engine: sim over "
             f"{char_dir.name}/gpu_rm1.json p95 {res.p95_ms:.3f} ms (p50 {res.p50_ms:.3f}, QPS "
             f"{res.measured_qps:.2f}) against the real engine's p95 {real_p95_ms:.3f} ms "
             f"(phase 6) [{card}]")
    return out, counts


def data_profiling(device, work: Path, card: str) -> tuple[dict, dict]:
    """``main.py --enable_profiling`` (its trace lists K1), then
    ``op_breakdown`` of rm1 and dien at OP_BATCHES."""
    res, counts = _count_path("main.py --enable_profiling", port_main.main, [
        "--model", "rm1", "--param_dtype", "bfloat16", "--table_scale", str(TABLE_SCALE),
        "--mini_batch_size", str(BATCH), "--num_batches", str(DATA_BATCHES),
        "--device", str(device), "--enable_profiling", "--profile_dir", str(work / "prof")])
    trace_file = Path(res["profile_trace"])
    if counts != _want(embedding_bag=res["forwards"]) or (
            "embedding_bag_kernel" not in trace_file.read_text()):
        raise AssertionError(f"profiled standalone: launches {counts}, or {trace_file.name} "
                             "lists no K1")
    _log(f"[15 data] profiled standalone: {trace_file.name}, "
         f"{trace_file.stat().st_size / 1e6:.2f} MB, lists K1")
    rows = []
    total = _want()
    for name in ("rm1", "dien"):
        for b in OP_BATCHES:
            r, c = _count_path(f"op_breakdown {name} batch {b}", op_breakdown.breakdown_for,
                               name, b, TABLE_SCALE, "bfloat16", device)
            _add(total, c)
            rows.append(r)
            top = sorted(r.get("kernel_device_us", {}).items(), key=lambda kv: -kv[1])[:4]
            _log(f"[15 data] op breakdown {name} bf16 batch {b}, us by stage: "
                 + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in r["stage_ms"].items())
                 + f"; one forward's device {_us(r.get('device_ms'))}, wall "
                 + f"{_us(r.get('wall_ms'))}; by kernel "
                 + "; ".join(f"{k[:40]} {v:.2f} us" for k, v in top) + f" [{card}]")
            _free(device)
    if total["embedding_bag"] == 0 or total["rnn_scan"] == 0:
        raise AssertionError(f"op_breakdown never launched K1 or K3: {total}")
    _add(total, counts)
    errs = {"embedding_bag": max(_k1_cases(device, name, OP_BATCHES, "op_breakdown's ids")
                                 for name in ("rm1", "dien")),
            "rnn_scan": max(rnn_cases(device, DIEN_T, b) for b in OP_BATCHES)}
    _log(f"[15 data] K3 ok at T={DIEN_T} B={OP_BATCHES} H={KERNEL_HIDDEN} (f32 and bf16, "
         f"with and without seq_lengths and h0): max |K3 - plain| {errs['rnn_scan']:.3e}")
    return {"breakdown": rows, "trace": trace_file.name, "errs": errs}, total


def k5_zipf_case(device, cfg, learning_rate: float) -> float:
    """K5 held to its plain version within its tolerance at
    ``train_planted``'s shape: an f32 table of ``cfg``'s size, one batch of
    QUALITY_BATCH zipf(1.2) ids (its head row in ~19% of the lookups).
    Returns the max |error|."""
    offsets = table_offsets(cfg, device)
    ids = torch.as_tensor(train_quality.zipf_batch(cfg, QUALITY_BATCH, np.random.default_rng(7)),
                          device=device)
    g = torch.Generator(device=device).manual_seed(9)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    grad = torch.randn((QUALITY_BATCH, cfg.num_tables, d), generator=g, device=device) * 1e-2
    table0 = (torch.rand((R, d), generator=g, device=device) - 0.5) * 0.1
    acc0 = torch.rand((R,), generator=g, device=device) * 1e-4
    table, acc = table0.clone(), acc0.clone()
    sparse_adagrad_step(table, acc, offsets, ids, grad, learning_rate)
    synchronize(device)
    want_t, want_a = table0.clone(), acc0.clone()
    sparse_adagrad_step_reference(want_t, want_a, offsets, ids, grad, learning_rate)
    tol, acc_tol = sparse_adagrad_tolerance(table0, acc0, offsets, ids, grad, learning_rate)
    del table0, acc0
    err, acc_err = (table - want_t).abs(), (acc - want_a).abs()
    what = f"rm1 f32 R={R} d={d} B={QUALITY_BATCH}, zipf(1.2) ids, lr {learning_rate}"
    if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
        raise AssertionError(f"K5 disagrees with its plain version ({what}): max |err| "
                             f"table {err.max().item():.3e}, acc {acc_err.max().item():.3e}")
    worst = max(err.max().item(), acc_err.max().item())
    _log(f"[15 data] K5 ok {what}: max |err| table {err.max().item():.3e}, accumulator "
         f"{acc_err.max().item():.3e}")
    del table, acc, want_t, want_a, tol, acc_tol, err, acc_err
    _free(device)
    return worst


def serve_trained_export(device, tr, rep: dict, card: str) -> tuple[dict, dict]:
    """The second half of the JAX lifecycle test (tests/test_train_quality.py
    :44-68) on the card: ``train_planted``'s model exported int8 row-wise
    (``export_serving_params``), checkpointed (``save_params``), served
    through ``ServingServer`` (one engine on the card, buckets
    (QUALITY_BATCH,)) over the holdout the trained AUC was taken on
    (``make_holdout``, seed-pure), the served AUC held within
    SERVED_AUC_TOL of the trained one; K4 must have served it. Returns both
    AUCs and the launches."""
    from deeprecsys_tpu_torch.utils.metrics_ml import auc

    sp, qcfg = port_train.export_serving_params(tr.params, tr.cfg)
    holdout = train_quality.make_holdout(tr.cfg, train_quality.planted_weights(tr.cfg),
                                         n_batches=rep["holdout_n"] // rep["batch"],
                                         batch=rep["batch"])
    scfg = ServingConfig(engine_backend=_backend(device), inference_engines=1,
                         batch_buckets=(rep["batch"],), max_mini_batch_size=rep["batch"],
                         sub_task_batch_size=rep["batch"])
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        save_params(Path(tmp) / "ck", bridge.params_to_numpy(sp, qcfg))
        del sp
        _reset_counts()
        server = ServingServer(qcfg, scfg, checkpoint_path=str(Path(tmp) / "ck"),
                               accel_device=str(device))
        server.start(timeout=600)
        try:
            scores, labels = [], []
            for idx, dense, _logits, y in holdout:
                out = server.predict(idx, dense=dense, timeout=120)
                scores.append(np.asarray(out["scores"], np.float32)[:, 0])
                labels.append(y)
        finally:
            server.stop()
        counts = _counts()
    served = auc(np.concatenate(scores), np.concatenate(labels).astype(int))
    if counts["embedding_bag_int8_rowwise"] == 0:
        raise AssertionError("the served int8 export never launched K4")
    if not abs(served - rep["final_auc"]) <= SERVED_AUC_TOL:
        raise AssertionError(f"the int8_rowwise export serves AUC {served:.4f}, the trained "
                             f"model {rep['final_auc']:.4f} (limit {SERVED_AUC_TOL})")
    _log(f"[15 data] train_planted's int8_rowwise export checkpointed and served through "
         f"ServingServer (one engine, {_backend(device)}, buckets ({rep['batch']},)): served "
         f"holdout AUC {served:.4f} against the trained {rep['final_auc']:.4f} (|diff| "
         f"{abs(served - rep['final_auc']):.4f} <= {SERVED_AUC_TOL}), {rep['holdout_n']} rows, "
         f"launches {_nonzero(counts)} [{card}]")
    return {"served_auc": served, "trained_auc": rep["final_auc"]}, counts


def data_train_qps(device, card: str) -> tuple[dict, dict]:
    """``train_planted`` on rm1 at full size (sparse tables, the JAX
    defaults), its holdout AUC against Bayes and its steps a second, its
    int8 row-wise export served (``serve_trained_export``); then
    ``qps_sweep`` on ``gpu`` for rm1 over QPS_ARRIVALS."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    (tr, rep), counts = _count_path("train_planted rm1", train_quality.train_planted, cfg,
                                    steps=QUALITY_STEPS, batch=QUALITY_BATCH,
                                    eval_every=QUALITY_STEPS // 4, log=lambda *a: None,
                                    device=str(device))
    for key in ("embedding_bag", "sparse_adagrad_step", "optimizer_update"):
        if counts[key] == 0:
            raise AssertionError(f"train_planted never launched {key}")
    if not rep["final_auc"] > 0.5:
        raise AssertionError(f"train_planted did not learn: {rep}")
    _log(f"[15 data] train_planted rm1 f32 table_scale {TABLE_SCALE}, sparse tables, "
         f"{rep['steps']} steps of "
         f"{rep['batch']}, lr {rep['lr']}, table_lr {rep['table_lr']}: holdout AUC "
         f"{rep['final_auc']:.4f} against Bayes {rep['bayes_auc']:.4f} (curve "
         + ", ".join(f"{p['step']}: {p['auc']:.4f}" for p in rep["auc_curve"])
         + f"); loss {rep['loss_first8']:.4f} -> {rep['loss_last8']:.4f}; "
         f"{rep['steps_per_s']:.2f} steps/s (host batches, step, loss read) [{card}]")
    rep["served"], scounts = serve_trained_export(device, tr, rep, card)
    _add(counts, scounts)
    del tr
    _free(device)
    errs = {"sparse_adagrad_step": k5_zipf_case(device, cfg, rep["table_lr"]),
            "embedding_bag": _k1_cases(
                device, "rm1", (QUALITY_BATCH,), "train_planted's zipf ids", "float32",
                ids=lambda c, b: train_quality.zipf_batch(c, b, np.random.default_rng(7)))}
    qps, qcounts = _count_path("qps_sweep rm1", qps_sweep.sweep, "rm1", _backend(device), QPS_SLA_MS,
                               QPS_ARRIVALS, 1, QPS_QUERIES, TABLE_SCALE, QPS_SUB_BATCH)
    if qcounts["embedding_bag"] == 0:
        raise AssertionError("qps_sweep never launched K1")
    _add(counts, qcounts)
    scfg = qps_sweep.serving_config(_backend(device), QPS_SLA_MS, QPS_ARRIVALS[0], 1,
                                    QPS_QUERIES, QPS_SUB_BATCH)
    buckets = [b for b in resolve_buckets(scfg) if b <= scfg.max_mini_batch_size]
    errs["embedding_bag"] = max(errs["embedding_bag"],
                                _k1_cases(device, "rm1", buckets, "qps_sweep's buckets"))
    _log(f"[15 data] qps_sweep rm1 bf16 table_scale {TABLE_SCALE}, {_backend(device)}, 1 engine, "
         f"sub-batch {QPS_SUB_BATCH}, "
         f"{QPS_QUERIES} queries ~N(165, 16) a rate: "
         + "; ".join(f"{r['arrival_ms']:.2f} ms -> QPS {r['qps']:.2f}, p95 {r['p95_ms']:.3f}"
                     for r in qps["sweep"])
         + f"; latency-bounded QPS (p95 <= {QPS_SLA_MS:.0f} ms) "
         f"{qps['latency_bounded_qps']:.2f} [{card}]")
    _free(device)
    return {"quality": rep, "qps": qps, "errs": errs}, counts


def phase_data(device, card: str, k1_uniform: dict, real_p95_ms: float) -> tuple[dict, dict]:
    """Phase 15: the data modes and the one-card experiments, each path
    read around itself. Returns the results and the launches."""
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = _want()
    out = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        work = Path(tmp)
        for key, fn, args in (("synthetic", data_synthetic, (k1_uniform,)),
                              ("criteo", data_criteo, ()),
                              ("sim", data_ladder_sim, (real_p95_ms,)),
                              ("profiling", data_profiling, ())):
            t1 = time.perf_counter()
            out[key], counts = fn(device, work, *args, card)
            _add(launches, counts)
            _log(f"[15 data] {key} in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["train_qps"], counts = data_train_qps(device, card)
    _add(launches, counts)
    _log(f"[15 data] training quality and QPS in {time.perf_counter() - t1:.1f} s")
    out["errs"] = {k: max(part["errs"].get(k, 0.0) for part in out.values()) for k in KERNELS}
    _log(f"[15 data] phase 15 in {time.perf_counter() - t0:.1f} s")
    return out, launches


# -------------------------------------------- phase 16: serving over meshes

def _cuda_mesh(device, D: int, M: int):
    """A D x M mesh whose every entry is ``device``: virtual shards on one
    card (every sharded path, launch and combine runs; no scaling shows)."""
    return make_mesh(D, M, devices=[device] * (D * M))


def _shard_tables(device, g, rows: int, d: int) -> dict:
    """Random tables of ``rows`` rows in the three layouts: bf16, per-table
    int8 (``q``) and row-wise int8 (``qrows``, positive row scales)."""
    table = torch.empty((rows, d), dtype=torch.bfloat16, device=device)
    table.uniform_(-1.0, 1.0, generator=g)
    qrows = torch.empty((rows, d + 4), dtype=torch.int8, device=device)
    qrows[:, :d] = torch.randint(-127, 128, (rows, d), generator=g, device=device,
                                 dtype=torch.int8)
    row_scale = torch.rand((rows,), generator=g, device=device) * 1e-2 + 1e-4
    qrows[:, d:] = row_scale.view(torch.int8).reshape(rows, 4)
    return {"none": table, "int8": qrows[:, :d].contiguous(), "int8_rowwise": qrows}


def _window_partial(quant: str, shard, offsets, idx, row_lo: int, mask, plain: bool = False):
    """The window kernel of ``quant``'s layout on a shard (or its plain version)."""
    w = (row_lo, row_lo + shard.shape[0])
    if quant == "none":
        if plain:
            return embedding_bag_reference(shard, offsets, idx, compute_dtype=torch.bfloat16,
                                           mask=mask, window=w)
        return embedding_bag_shard(shard, offsets, idx, row_lo, compute_dtype=torch.bfloat16,
                                   mask=mask)
    if quant == "int8":
        if plain:
            return embedding_bag_int8_reference(shard, None, offsets, idx, mask=mask, window=w)
        return embedding_bag_int8_shard(shard, offsets, idx, row_lo, mask=mask)
    if plain:
        return embedding_bag_int8_rowwise_reference(shard, offsets, idx, mask=mask, window=w)
    return embedding_bag_int8_rowwise_shard(shard, offsets, idx, row_lo, mask=mask)


def _hotcold_partial(quant: str, hot, shard, split: dict, plain: bool = False):
    """K6 on a shard in ``quant``'s layout (or its plain version); ``hot``
    None: the cold-only route of a shard that counts no hot hit (``split``:
    its cold stream and ``bags``)."""
    if hot is None:
        if plain:
            return embedding_bag_cold_partial_reference(
                shard, split, mode={"none": "float"}.get(quant, quant),
                compute_dtype=torch.bfloat16 if quant == "none" else None)
        kw = {"compute_dtype": torch.bfloat16} if quant == "none" else {}
        return {"none": embedding_bag_hotcold_shard, "int8": embedding_bag_hotcold_int8_shard,
                "int8_rowwise": embedding_bag_hotcold_int8_rowwise_shard}[quant](
                    None, shard, split, **kw)
    if quant == "none":
        if plain:
            return embedding_bag_hotcold_reference(hot, shard, split,
                                                   compute_dtype=torch.bfloat16, partial=True)
        return embedding_bag_hotcold_shard(hot, shard, split, compute_dtype=torch.bfloat16)
    if quant == "int8":
        if plain:
            return embedding_bag_hotcold_int8_reference(hot, shard, None, split, partial=True)
        return embedding_bag_hotcold_int8_shard(hot, shard, split)
    if plain:
        return embedding_bag_hotcold_int8_rowwise_reference(hot, shard, split, partial=True)
    return embedding_bag_hotcold_int8_rowwise_shard(hot, shard, split)


def _hotcold_tol(quant: str, hot, split: dict):
    """The tolerance of K6 on a shard (``_check_partial``'s): the cold-only
    route's (``hot`` None) or the hot/cold one's."""
    rowwise = quant == "int8_rowwise"
    if hot is None:
        return lambda a, b, t, *r: cold_tolerance(a, b, t, split, rowwise=rowwise)
    return lambda a, b, t, *r: hotcold_tolerance(a, b, hot, t, split, rowwise=rowwise)


def _check_partial(quant: str, got, want, table, what: str, tolerance, *args) -> float:
    """A partial held to its plain one: per-table int8 bit for bit (int32),
    the others within ``tolerance(got, want, table, *args)``."""
    if quant == "int8":
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"{what}: the int32 partial differs from its plain version")
        return 0.0
    if got.dtype != torch.float32:
        raise AssertionError(f"{what}: the partial is {got.dtype}, not float32")
    tol = tolerance(got, want, table, *args)
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: differs from its plain version by {err.max().item():.3e}, "
                             f"{int((err > tol).sum())} elements over tolerance")
    return err.max().item()


def _finish(quant: str, acc, scale=None):
    if quant == "int8":
        return (acc.float() * scale[None, :, None]).to(torch.bfloat16)
    return acc.to(torch.bfloat16)


def _merge(errs: dict, key: str, err: float):
    errs[key] = max(errs.get(key, 0.0), err)


def _layout_leaf(tables):
    """The 2-D leaf of a table layout (the table, ``q`` or ``qrows``)."""
    if not isinstance(tables, dict):
        return tables
    return tables["qrows"] if "qrows" in tables else tables["q"]


def _window_cells(quant: str, sp, d: int, offsets, indices, mask, what: str,
                  errs: dict) -> float:
    """The window kernel of every shard of ``sp``'s data row ``d`` at this
    slice's shape (``indices``/``mask`` on the card), each held to its plain
    version as ``_check_partial`` holds it; the max |error| goes into
    ``errs``."""
    tol = {"none": pooled_tolerance, "int8_rowwise": rowwise_tolerance, "int8": None}[quant]
    rps, worst = sp.rows_per_shard, 0.0
    for m in range(sp.mesh.shape["model"]):
        shard, lo = _layout_leaf(sp.entry(d, m)["tables"]), m * rps
        # on the shard's own card (a mesh over several cards)
        offs, idx = offsets.to(shard.device), indices.to(shard.device)
        msk = None if mask is None else mask.to(shard.device)
        got = _window_partial(quant, shard, offs, idx, lo, msk)
        synchronize(shard.device)
        want = _window_partial(quant, shard, offs, idx, lo, msk, plain=True)
        worst = max(worst, _check_partial(
            quant, got, want, shard,
            f"{what}: shard {m} (rows [{lo}, {lo + rps})), b={indices.shape[0]}, "
            f"mask={'yes' if mask is not None else 'no'}",
            lambda a, b, t: tol(a, b, t, offs, idx, msk, window=(lo, lo + rps))))
    _merge(errs, SHARD[quant], worst)
    return worst


def _on(x, device):
    return torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x).to(device)


def _hotcold_cells(quant: str, hp, split: dict, what: str, errs: dict) -> float:
    """K6 on every (data, model) cell of a mesh hot/cold lookup, as
    ``parallel/sharding.py::_hotcold_row`` launches it: cell (d, 0) takes
    data slice d's hot hits and its own cold stream, every other cell its
    cold stream alone (the cold-only route; ``split``: tensor-parallel
    ``(M, C_pad)`` or hybrid ``(D, M, C_pad)``, segments local to the
    slice, pad ``b_loc * T``), on ``hp``'s shard (and hot table); each held
    to its plain version."""
    mesh = hp.mesh
    D, M = mesh.shape["data"], mesh.shape["model"]
    b = split["hot_sel"].shape[0] // D
    worst = 0.0
    for d in range(D):
        for m in range(M):
            e = hp.entry(d, m)
            shard, hot = _layout_leaf(e["tables"]), e["hot_table"]
            dev = shard.device
            cold = (lambda k: split[k][d][m]) if D > 1 else (lambda k: split[k][m])
            cell = {"cold_ids": _on(cold("cold_local"), dev),
                    "cold_seg": _on(cold("cold_seg"), dev)}
            if m == 0:
                cell.update(hot_sel=_on(split["hot_sel"][d * b:(d + 1) * b], dev),
                            hot_mask=_on(split["hot_mask"][d * b:(d + 1) * b], dev))
            else:
                hot, cell["bags"] = None, (b, split["hot_sel"].shape[1])
            got = _hotcold_partial(quant, hot, shard, cell)
            synchronize(dev)
            want = _hotcold_partial(quant, hot, shard, cell, plain=True)
            worst = max(worst, _check_partial(
                quant, got, want, shard,
                f"{what}: cell ({d}, {m}), b={b}, C_pad {cell['cold_ids'].numel()}"
                + ("" if m == 0 else ", cold-only"), _hotcold_tol(quant, hot, cell)))
    _merge(errs, HOTCOLD_SHARD[quant], worst)
    return worst


def _tablewise_cells(quant: str, tw_params: dict, batch: Batch, what: str, errs: dict) -> float:
    """The direct kernel of every table-wise (data slice, shard) cell at its
    shape (the shard's placed tables, their offsets within it, virtual pad
    slots on row 0), held to its plain version: K1-int8 bit for bit."""
    worst = 0.0
    for d, s, idx, msk, offs, scale in tw_params["plan"].cells(batch.indices, batch.mask):
        tbl = tw_params["tables_tw"].part(d, s)
        tables = {"none": tbl, "int8": {"q": tbl, "scale": scale},
                  "int8_rowwise": {"qrows": tbl}}[quant]
        got = direct_call(quant, tables, offs, idx, torch.bfloat16, mask=msk)
        synchronize(tbl.device)
        cell = f"{what}: cell ({d}, {s}), {idx.shape[1]} placed tables"
        if quant == "int8":
            want = embedding_bag_int8_reference(tbl, scale, offs, idx,
                                                compute_dtype=torch.bfloat16, mask=msk)
            if not torch.equal(got, want):
                raise AssertionError(f"{cell}: K1-int8 differs from its plain version")
            continue
        want = (embedding_bag_reference if quant == "none"
                else embedding_bag_int8_rowwise_reference)(tbl, offs, idx,
                                                           compute_dtype=torch.bfloat16, mask=msk)
        worst = max(worst, _check_pooled(
            got, want, tbl, offs, idx, msk, cell,
            tolerance=pooled_tolerance if quant == "none" else rowwise_tolerance,
            kernel=LOOKUP[quant]))
    _merge(errs, LOOKUP[quant], worst)
    return worst


def _bucket_windows(device, cfg, sp, buckets, what: str, errs: dict,
                    quant: str = "none") -> float:
    """The window kernel of ``quant``'s layout at a mesh engine's buckets:
    data slice 0's ids (and a ragged mask) of a ``bucket``-row batch on
    every shard of row 0, each on its shard's card."""
    D = sp.mesh.shape["data"]
    offsets = table_offsets(cfg, device)
    worst = 0.0
    for n in buckets:
        _, _, idx, mask = _case_inputs(device, cfg, n, None, seed=60 + n)
        for m_ in (None, mask):
            worst = max(worst, _window_cells(quant, sp, 0, offsets, idx[:n // D],
                                             None if m_ is None else m_[:n // D],
                                             f"{what} bucket {n}", errs))
    return worst


def mesh_kernel_cases(device, name: str, seed: int, card: str) -> tuple[dict, dict]:
    """K1, K1-int8 and K4 with the ownership window, and K6 in the three
    layouts on a shard's cold stream (with the hits on shard 0, on the
    cold-only route on the others), at ``name``'s full shape and its 1/4
    row shards (rm1: all four, their partials combined and held to the
    direct kernels; rm2: its second shard), on the generator's ids (masked
    and not) and zipf(1.2) ids; each held to its plain version (int32
    partials bit for bit). At rm1 the direct K1 is held to the full window's
    partial rounded once, bit for bit, and each kernel is timed at shard
    1's shape (K6 also at shard 0's, with the hits). Returns the max |error|
    and the times by kernel."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    g, offsets, indices, mask = _case_inputs(device, cfg, BATCH, None, seed)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    rps = R // MESH_SHARDS
    full = name == "rm1"
    shards = range(MESH_SHARDS) if full else (1,)
    tables = _shard_tables(device, g, R if full else rps, d)
    base = 0 if full else rps  # the fused row of the tables' first row
    scale = torch.rand((cfg.num_tables,), generator=g, device=device) * 1e-2 + 1e-4
    errs, times = {}, {}
    tol = {"none": pooled_tolerance, "int8_rowwise": rowwise_tolerance, "int8": None}
    for quant in ("none",) + QUANT_MODES:
        key = SHARD[quant]
        table = tables[quant]
        for m_ in (None, mask):
            parts = []
            for m in shards:
                lo = m * rps
                shard = table[lo - base:lo - base + rps]
                what = (f"{name} {quant} shard {m} of {MESH_SHARDS} (rows [{lo}, {lo + rps})), "
                        f"B={BATCH} T={cfg.num_tables} L={cfg.num_indices_per_lookup}, "
                        f"mask={'yes' if m_ is not None else 'no'}")
                got = _window_partial(quant, shard, offsets, indices, lo, m_)
                synchronize(device)
                want = _window_partial(quant, shard, offsets, indices, lo, m_, plain=True)
                err = _check_partial(quant, got, want, shard, what,
                                     lambda a, b, t, *r: tol[quant](a, b, t, offsets, indices,
                                                                    m_, window=(lo, lo + rps)))
                errs[key] = max(errs.get(key, 0.0), err)
                parts.append(got)
            if full:  # the shards' partials combined, against the direct kernel
                direct = direct_call(quant, {"none": table, "int8": {"q": table, "scale": scale},
                                             "int8_rowwise": {"qrows": table}}[quant],
                                     offsets, indices, torch.bfloat16, mask=m_)
                acc = parts[0]
                for p_ in parts[1:]:
                    acc = acc + p_
                combined = _finish(quant, acc, scale)
                what = f"{name} {quant}: {MESH_SHARDS} shards combined against the direct kernel"
                if quant == "int8":
                    if not torch.equal(combined, direct):
                        raise AssertionError(f"{what}: not bit for bit")
                else:
                    _check_pooled(combined, direct, table, offsets, indices, m_, what,
                                  tolerance=tol[quant], kernel=key)
        _log(f"[16 mesh] {key} ok at {name}'s {len(shards)} shard(s) of {MESH_SHARDS}, "
             f"masked and not: max |err| {errs[key]:.3e} against the plain version"
             + (f"; the {MESH_SHARDS} partials combined match the direct kernel"
                + (" bit for bit" if quant == "int8" else "") if full else ""))
    if full:  # K1-int8's and K4's windows where the shard's edges fall mid-table
        straddling_window_cases(device, cfg, tables, offsets, indices, mask, errs)
    if full:  # the direct path: the full window's partial rounded once is K1
        got = embedding_bag_shard(tables["none"], offsets, indices, 0,
                                  compute_dtype=torch.bfloat16).to(torch.bfloat16)
        if not torch.equal(got, embedding_bag(tables["none"], offsets, indices)):
            raise AssertionError("rm1: the full window's partial, rounded, is not the direct K1")
        _log("[16 mesh] rm1: K1 with the full window [0, R), rounded once, equals the direct "
             "K1 bit for bit")

    # K6 on a shard's cold stream (zipf ids, the JAX hot-set rule): the hot
    # set fitted on a warm-up batch, as the refreshing engine fits it on
    # earlier traffic; checked on that batch and on a later one, timed on
    # the later ones.
    zipf = zipf_stream(cfg, BATCH, seed=seed + 20)
    hot_ids, cov = _hot_set(cfg, zipf)
    offs64 = np.asarray(cfg.table_offsets, dtype=np.int64)
    buckets = cold_buckets_for(zipf.size, _cuda_mesh(device, 1, MESH_SHARDS))
    later = [zipf_stream(cfg, BATCH, seed=seed + 21 + i) for i in range(K6_TIMED_BATCHES)]
    batches = [(b, hotcold_ops.split_hot_cold_sharded(b, offs64, hot_ids, MESH_SHARDS, rps,
                                                      cold_buckets=buckets, impl="native"))
               for b in [zipf] + later]
    hid = torch.as_tensor(hot_ids, dtype=torch.int64, device=device)

    def shard_split(m: int, split: dict) -> dict:
        """Shard m's call as the mesh path makes it: the hits on shard 0,
        the cold-only route (its cold stream and ``bags``) on the others."""
        sp = {"cold_ids": torch.from_numpy(split["cold_local"][m]).to(device),
              "cold_seg": torch.from_numpy(split["cold_seg"][m]).to(device)}
        hot_sel = torch.from_numpy(split["hot_sel"]).to(device)
        if m == 0:
            return dict(sp, hot_sel=hot_sel, hot_mask=torch.from_numpy(split["hot_mask"]).to(device))
        return dict(sp, bags=tuple(hot_sel.shape[:2]))

    for quant in ("none",) + QUANT_MODES:
        key = HOTCOLD_SHARD[quant]
        table = tables[quant]
        # The hot rows: the table's where it is whole, random rows of its
        # layout at rm2 (the plain version takes the same ones).
        hot = (table.index_select(0, hid) if full
               else table.index_select(0, hid % table.shape[0]))
        for n, (ids_np, split) in enumerate(batches[:2]):
            which = "the warm-up batch" if n == 0 else "a later batch"
            parts = []
            for m in shards:
                shard = table[m * rps - base:m * rps - base + rps]
                sp = shard_split(m, split)
                h = hot if m == 0 else None
                what = (f"{name} {quant} K6 on shard {m} of {MESH_SHARDS}: zipf(1.2), {which}, "
                        f"K={len(hot_ids)} (coverage of the warm-up batch {cov:.4f}), C_pad "
                        f"{sp['cold_ids'].numel()}" + ("" if m == 0 else ", cold-only"))
                got = _hotcold_partial(quant, h, shard, sp)
                synchronize(device)
                want = _hotcold_partial(quant, h, shard, sp, plain=True)
                err = _check_partial(quant, got, want, shard, what, _hotcold_tol(quant, h, sp))
                errs[key] = max(errs.get(key, 0.0), err)
                parts.append(got)
            if full:
                acc = parts[0]
                for p_ in parts[1:]:
                    acc = acc + p_
                combined = _finish(quant, acc, scale)
                direct = direct_call(quant, {"none": table, "int8": {"q": table, "scale": scale},
                                             "int8_rowwise": {"qrows": table}}[quant],
                                     offsets, torch.from_numpy(ids_np).to(device), torch.bfloat16)
                what = (f"{name} {quant}: K6 on {MESH_SHARDS} shards combined against the direct "
                        f"kernel ({which})")
                if quant == "int8":
                    if not torch.equal(combined, direct):
                        raise AssertionError(f"{what}: not bit for bit")
                else:
                    _check_pooled(combined, direct, table, offsets,
                                  torch.from_numpy(ids_np).to(device), None, what,
                                  tolerance=tol[quant], kernel=key)
        _log(f"[16 mesh] {key} ok at {name}'s {len(shards)} shard(s), on the warm-up batch and a "
             f"later one: max |err| {errs[key]:.3e} against the plain version"
             + (" (int32, bit for bit)" if quant == "int8" else "")
             + (f"; shards 1-{MESH_SHARDS - 1} on the cold-only route, combined with shard 0's "
                f"hits, the direct kernel's pool" if full else "; shard 1 on the cold-only route"))

    # Times at shard 1's shape: the kernel, its plain version, the library call.
    lo = rps
    for quant in ("none",) + QUANT_MODES:
        shard = tables[quant][lo - base:lo - base + rps]
        ids = [(b,) for b in (indices,)]
        k = measure(lambda i: _window_partial(quant, shard, offsets, i, lo, None), ids,
                    TIMED_ITERS)
        pl = measure(lambda i: _window_partial(quant, shard, offsets, i, lo, None, plain=True),
                     ids, TIMED_ITERS)
        lib = (measure(window_library(shard, lo, offsets), ids, TIMED_ITERS)
               if quant == "none" else None)
        bound = window_bound(shard, lo, offsets, indices, d, 2 if quant == "int8_rowwise" else 1)
        times[SHARD[quant]] = {
            "ms": k["kernel_ms"], "plain_ms": pl["device_ms"],
            "library_ms": None if lib is None else lib["device_ms"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        t = times[SHARD[quant]]
        _log(f"[16 mesh] {SHARD[quant]} at {name}'s shard 1 of {MESH_SHARDS} (B={BATCH}, "
             f"{bound['bytes'] / 1e6:.2f} MB moved): {_us(t['ms'])} device (virtual shard on one "
             f"card); bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); plain "
             f"{_us(t['plain_ms'])}; library {_us(t['library_ms'])}; wall a call "
             f"{k['wall_ms'] * 1e3:.2f} us [{card}]")
    # K6 on a shard, as the path calls it: shard 1 on the cold-only route
    # (the call of every shard m >= 1, three launches of four) and shard 0
    # with the hits, over the later batches; the bound over the same ones.
    for quant in ("none",) + QUANT_MODES:
        for m in (1, 0) if full else (1,):  # rm2's table holds shard 1 alone
            shard = tables[quant][m * rps - base:m * rps - base + rps]
            sps = [shard_split(m, split) for _, split in batches[1:]]
            hot = tables[quant].index_select(0, hid % tables[quant].shape[0]) if m == 0 else None
            args = [(sp,) for sp in sps]
            k = measure(lambda s_: _hotcold_partial(quant, hot, shard, s_), args, TIMED_ITERS)
            pl = measure(lambda s_: _hotcold_partial(quant, hot, shard, s_, plain=True), args,
                         TIMED_ITERS)
            lib = (measure(window_library(shard, m * rps, offsets),
                           [(torch.from_numpy(b).to(device),) for b, _ in batches[1:]],
                           TIMED_ITERS) if quant == "none" else None)
            mode = "float" if quant == "none" else quant
            bound = mean_bound([k6_cold_bound(shard, sp, mode) if m else
                                k6_bound(hot, shard, sp, torch.float32, mode) for sp in sps])
            sp = sps[0]
            t = {"ms": k["launch_sum_ms"], "plain_ms": pl["device_ms"],
                 "library_ms": None if lib is None else lib["device_ms"],
                 "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
            times[HOTCOLD_SHARD[quant] + ("" if m else " shard 0")] = t
            _log(f"[16 mesh] {HOTCOLD_SHARD[quant]} at {name}'s shard {m} (zipf, the "
                 f"{K6_TIMED_BATCHES} batches after the warm-up, C_pad "
                 f"{sp['cold_ids'].numel()}, {'the cold-only route' if m else 'with the hits'}): "
                 f"{_us(t['ms'])} device, {k['launches']:.0f} launch(es) a call ("
                 f"{', '.join(k['kernels'])}; virtual shard on one card); bound "
                 f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}, "
                 f"{bound['bytes'] / 1e6:.3f} MB); plain {_us(t['plain_ms'])}; windowed "
                 f"F.embedding_bag {_us(t['library_ms'])} [{card}]")
    del tables
    _free(device)
    return errs, times


def straddling_window_cases(device, cfg, tables: dict, offsets, indices, mask, errs: dict):
    """K1-int8's and K4's windows on ``cfg``'s shard 1 of MESH_SHARDS
    shifted by half of the first table (three tables meet it, the first and
    last straddling a shard edge; ``tables`` the whole tables of
    ``_shard_tables``), masked and not, against their plain versions: the
    int32 pool bit for bit, K4 within ``rowwise_tolerance`` of the window;
    the aligned shards are ``mesh_kernel_cases``' own. The meeting tables
    come from the wrapper (derived from the offsets) and from
    ``table_range`` with the fused rows, as a placement makes it."""
    rps = cfg.total_rows // MESH_SHARDS
    lo = rps + cfg.scaled_rows[0] // 2
    w = (lo, lo + rps)
    placed = table_range(cfg.table_offsets, lo, rps, cfg.total_rows)
    for quant, fn in (("int8", embedding_bag_int8_shard),
                      ("int8_rowwise", embedding_bag_int8_rowwise_shard)):
        shard = tables[quant][lo:lo + rps]
        for tr in (None, placed):
            for m_ in (None, mask):
                got = fn(shard, offsets, indices, lo, mask=m_, table_range=tr)
                synchronize(device)
                want = _window_partial(quant, shard, offsets, indices, lo, m_, plain=True)
                what = (f"rm1 {quant} window rows [{lo}, {lo + rps}) (tables "
                        f"[{placed.lo}, {placed.hi}), {'given' if tr else 'derived'}), "
                        f"mask={'yes' if m_ is not None else 'no'}")
                err = _check_partial(quant, got, want, shard, what,
                                     lambda a, b, t, *r: rowwise_tolerance(
                                         a, b, t, offsets, indices, m_, window=w))
                errs[SHARD[quant]] = max(errs.get(SHARD[quant], 0.0), err)
        _log(f"[16 mesh] {SHARD[quant]} ok on rm1's window shifted by half a table (rows "
             f"[{lo}, {lo + rps}), tables [{placed.lo}, {placed.hi}), straddling "
             f"{placed.lo_edge}/{placed.hi_edge}), masked and not, with the range given and "
             f"derived: max |err| {errs[SHARD[quant]]:.3e} so far"
             + (" (int32, bit for bit)" if quant == "int8" else ""))


def _mesh_launch_check(counts: dict, want: dict, what: str):
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {want}")


def mesh_rm1(device, fwd: dict, times: dict, card: str, errs: dict) -> tuple[dict, dict]:
    """rm1 (phase 5's params) through ``sharded_apply`` on 1x4, 2x2 and 4x1
    meshes of the card: three forwards each held to the single-device
    forward (bf16_atol), the launches read around them (D*M window K1 a
    forward), the window K1 of every shard at the first and last data
    slice's shape held to its plain version, peak memory; then 100 back-to-back forwards over 8 batches,
    wall (CUDA events) and device time (torch.profiler), beside phase 7's
    single-device forward."""
    cfg, model, params, batches = fwd["cfg"], fwd["model"], fwd["params"], fwd["batches"]
    timed = [(b.to(device),) for b in RecDataGenerator(cfg, seed=3).generate_batches(8, BATCH)]
    launches, out = _want(), {}
    with torch.inference_mode():
        wants = [model.apply(params, b).float().cpu().numpy() for b in batches]
        for D, M in MESH_AXES:
            mesh = _cuda_mesh(device, D, M)
            _reset_peak(device)
            sp = shard_params(params, mesh)
            fn = sharded_apply(model, mesh, has_dense=True)
            _reset_counts()
            outs = [fn(sp, b) for b in batches]
            synchronize(device)
            counts = _counts()
            _mesh_launch_check(counts, _want(embedding_bag_shard=len(batches) * D * M),
                               f"rm1 sharded_apply {D}x{M}")
            _add(launches, counts)
            worst = max(_check_close(o.float().cpu().numpy(), w, f"rm1 sharded_apply {D}x{M}")
                        for o, w in zip(outs, wants))
            peak = _peak_gib(device)  # before the checks' plain versions allocate
            b, offsets = BATCH // D, table_offsets(fwd["cfg"], device)
            k1_err = max(_window_cells("none", sp, d, offsets, batches[0].indices[d * b:(d + 1) * b],
                                       None, f"rm1 sharded_apply {D}x{M} slice {d}", errs)
                         for d in sorted({0, D - 1}))
            r = measure(lambda b: fn(sp, b), timed, TIMED_ITERS)
            dev = r["device_ms"]
            out[f"{D}x{M}"] = {"wall_ms": r["wall_ms"], "device_ms": dev, "peak_gib": peak,
                               "k1_window_ms": r["kernel_ms"], "max_abs_err": worst,
                               "device_ops": r["launches"]}
            idle = "not measured" if dev is None else f"{100 * (1 - dev / r['wall_ms']):.1f}%"
            _log(f"[16 mesh] rm1 sharded_apply on a {D}x{M} mesh of one card (virtual shards): "
                 f"{len(batches)} forwards match the single-device forward (max |err| "
                 f"{worst:.3e}, limit bf16_atol), launches {counts}, window K1 of each shard at "
                 f"b={b} max |err| {k1_err:.3e} against its plain version, peak {peak:.3f} GiB; "
                 f"{TIMED_ITERS} back-to-back forwards: wall {r['wall_ms']:.4f} ms, device "
                 f"{_us(dev)} in {r['launches']:.0f} device ops, idle {idle}; window K1 median "
                 f"{_us(r['kernel_ms'])}; device time by kernel: {_top(r)} [{card}]")
            del sp, fn, outs
    _log(f"[16 mesh] rm1 forward wall / device, virtual shards on one card: 1x1 (phase 7) "
         f"{times['fwd_wall_ms']:.4f} ms / {_us(times['fwd_device_ms'])}; "
         + "; ".join(f"{k} {v['wall_ms']:.4f} ms / {_us(v['device_ms'])}" for k, v in out.items())
         + f" [{card}]")
    return out, launches


def mesh_zoo(device, z: dict, card: str, errs: dict) -> tuple[dict, dict]:
    """Phase 8's model ``z`` through ``sharded_apply`` on a 1x4 mesh of the
    card: three forwards held to its single-device forward (bf16_atol), the
    launches read around them, the window K1 of every shard at the model's
    shape held to its plain version, peak memory (the shards are views of
    the table: no copy)."""
    cfg, model, params, name = z["cfg"], z["model"], z["params"], z["name"]
    batches = [b.to(device) for b in RecDataGenerator(cfg, seed=1).generate_batches(3, BATCH)]
    mesh = _cuda_mesh(device, 1, MESH_SHARDS)
    with torch.inference_mode():
        wants = [model.apply(params, b).float().cpu().numpy() for b in batches]
        _reset_peak(device)
        sp = shard_params(params, mesh)
        fn = sharded_apply(model, mesh, has_dense=cfg.dense_dim > 0)
        _reset_counts()
        outs = [fn(sp, b) for b in batches]
        synchronize(device)
        counts = _counts()
    # A table whose rows do not divide the shards is replicated: the direct
    # K1 on each data row (at full size every zoo table divides 4).
    lookups = ({"embedding_bag_shard": len(batches) * MESH_SHARDS} if sp.rows_per_shard
               else {"embedding_bag": len(batches)})
    _mesh_launch_check(counts, _want(**lookups, rnn_scan=2 * len(batches)
                                     if cfg.model_type == "dien" else 0),
                       f"{name} sharded_apply 1x{MESH_SHARDS}")
    worst = max(_check_close(o.float().cpu().numpy(), w, f"{name} sharded_apply")
                for o, w in zip(outs, wants))
    peak = _peak_gib(device)  # before the checks' plain versions allocate
    k1 = ""
    if sp.rows_per_shard:
        err = _window_cells("none", sp, 0, table_offsets(cfg, device), batches[0].indices,
                            batches[0].mask, f"{name} sharded_apply 1x{MESH_SHARDS}", errs)
        k1 = f", window K1 of each shard max |err| {err:.3e} against its plain version"
    _log(f"[16 mesh] {name} sharded_apply on a 1x{MESH_SHARDS} mesh of one card: "
         f"{len(batches)} forwards match the single-device forward (max |err| {worst:.3e}, "
         f"limit bf16_atol), launches {counts}{k1}, peak {peak:.3f} GiB [{card}]")
    return {"name": name, "max_abs_err": worst, "peak_gib": peak}, counts


def mesh_layouts(device, fwd: dict, card: str, errs: dict) -> tuple[dict, dict]:
    """rm1 in the three table layouts on zipf(1.2) ids (the JAX hot-set
    rule): ``sharded_apply`` (1x4), the table-wise model (1x4), hot/cold
    tensor-parallel (1x4) and hybrid (2x2); each forward held to the
    layout's single-device direct forward (bf16_atol), its launches read
    around it; then each path's kernel on every cell at that path's shape
    held to its plain version (the window kernel on each shard, the direct
    kernel on each table-wise shard, K6 on each (data, model) cell)."""
    launches, out = _want(), {}
    mesh14, mesh22 = _cuda_mesh(device, 1, MESH_SHARDS), _cuda_mesh(device, 2, 2)
    for quant in ("none",) + QUANT_MODES:
        if quant == "none":
            cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
        else:
            cfg = fwd["cfg"].replace(table_quant=quant)
            model = get_model(cfg, device)
            params = model.init(torch.Generator(device=device).manual_seed(0))
        zipf = zipf_stream(cfg, BATCH, seed=31)
        dense = np.random.default_rng(31).random((BATCH, cfg.dense_dim), dtype=np.float32)
        host = Batch(dense=dense, indices=zipf)
        batch = host.to(device)
        hot_ids, cov = _hot_set(cfg, zipf)
        with torch.inference_mode():
            want = model.apply(params, batch).float().cpu().numpy()
            paths = {}
            sp = shard_params(params, mesh14)
            paths["sharded 1x4"] = (lambda: sharded_apply(model, mesh14, True)(sp, batch),
                                    {SHARD[quant]: MESH_SHARDS})
            tw = make_tablewise_model(model, mesh14)
            tw_params = tw.convert_params(params)
            paths["table-wise 1x4"] = (lambda: tw.apply(tw_params, batch),
                                       {LOOKUP[quant]: MESH_SHARDS})
            hcs = {}
            for label, mesh in (("hot/cold tensor-parallel 1x4", mesh14),
                                ("hot/cold hybrid 2x2", mesh22)):
                hc = make_hotcold_model(model, hot_ids, mesh=mesh)
                hp = shard_params(hc.convert_params(params), mesh)
                hcs[label] = (hc, hp)
                paths[label] = (lambda hc=hc, hp=hp: hc.apply(
                    hp, Batch(dense=batch.dense, indices=None), hc.prepare(host)),
                    {HOTCOLD_SHARD[quant]: mesh.size})
            res = {}
            for label, (run, launched) in paths.items():
                _reset_counts()
                got = run()
                synchronize(device)
                counts = _counts()
                _mesh_launch_check(counts, _want(**launched), f"rm1 {quant} {label}")
                _add(launches, counts)
                res[label] = _check_close(got.float().cpu().numpy(), want,
                                          f"rm1 {quant} {label}")
            cells = {"sharded 1x4": _window_cells(
                         quant, sp, 0, table_offsets(cfg, device), batch.indices, batch.mask,
                         f"rm1 {quant} sharded 1x4 on zipf ids", errs),
                     "table-wise 1x4": _tablewise_cells(quant, tw_params, batch,
                                                        f"rm1 {quant} table-wise 1x4", errs)}
            for label, (hc, hp) in hcs.items():
                cells[label] = _hotcold_cells(quant, hp, hc.prepare(host), f"rm1 {quant} {label}",
                                              errs)
        _log(f"[16 mesh] rm1 {quant} tables on zipf(1.2) ids (K={len(hot_ids)}, coverage "
             f"{cov:.4f}), each against the single-device direct forward (limit bf16_atol): "
             + "; ".join(f"{k} max |err| {v:.3e}" for k, v in res.items())
             + "; each cell's kernel against its plain version: "
             + "; ".join(f"{k} {v:.3e}" for k, v in cells.items())
             + (" (int32 and K1-int8 bit for bit)" if quant == "int8" else "") + f" [{card}]")
        out[quant] = res
        del sp, tw_params, paths, hp, hcs
        if quant != "none":
            del params
        _free(device)
    return out, launches


def _mesh_tally(device, eng, want, what: str) -> str:
    """On a card every program of the mesh engine ``eng`` holds a graph
    whose capture tallied ``want`` (launches by kernel name, one a shard;
    or ``want(key)`` for program ``key``), so the launches read around its
    run are its executions times that tally. Returns the line that says so
    (the CPU captures nothing)."""
    if device.type != "cuda":
        return "no capture on the CPU"
    for p in eng.programs:
        got = {w.__name__: n for w, n in p.launches.items()}
        expected = want(p.key) if callable(want) else want
        if p.graph is None or got != expected:
            raise AssertionError(f"{what}: program {p.key} captured {p.graph is not None}, "
                                 f"tally {got}, expected {expected}")
    return ("each program's capture tally one launch a shard, so launches = executions x "
            "tally")


def _mesh_programs_line(eng) -> str:
    return (f"eager_reason {eng.eager_reason}; {_programs_line(eng)} (first set "
            f"{eng.programs.capture_ms:.1f} ms)")


def mesh_engine_payloads(device, fwd: dict, card: str, errs: dict) -> tuple[float, dict]:
    """Payload requests (32, 17 and 100 rows) and a ragged one (64 rows,
    masked) through one rm1 engine on a 2x2 mesh of the card (phase 5's
    params), its programs captured at warm-up: scores held to
    ``model.apply`` on the same rows (bf16_atol); D*M window K1 launches an
    execution, each replay its capture's tally; each program's first
    replay held to ``model.apply`` on its warm rows (``check_programs``);
    the window K1 at every bucket's slice, masked and not, held to its
    plain version."""
    cfg, model, params = fwd["cfg"], fwd["model"], fwd["params"]
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device), accept_ragged=True)
    data = RecDataGenerator(cfg, seed=40)
    payloads = [data.generate_batch(n) for n in (32, 17, 100)]
    rag = data.generate_batch(64)
    payloads.append(rag._replace(mask=np.random.default_rng(41).random(rag.indices.shape) < 0.6))
    mesh = _cuda_mesh(device, 2, 2)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    _reset_counts()
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, params=params, mesh=mesh)
    eng.start()
    ready = ready_q.get(timeout=300)
    if isinstance(ready, Exception):
        raise RuntimeError("the mesh payload engine failed during setup") from ready
    for i, p in enumerate(payloads):
        req_q.put(ServiceRequest(batch_id=i, batch_size=len(p.indices),
                                 arrival_time=time.time(), payload=p))
    req_q.put(None)
    got = {}
    for _ in payloads:
        r = resp_q.get(timeout=120)
        got[r.batch_id] = r
    eng.join(timeout=120)
    counts = _counts()
    ex = _executions(eng)
    _mesh_launch_check(counts, _want(embedding_bag_shard=mesh.size * ex),
                       f"mesh payload engine ({ex} executions)")
    if eng.error is not None:
        raise AssertionError(f"mesh payload engine: {eng.error!r}")
    tally = _mesh_tally(device, eng, {"embedding_bag_shard": mesh.size}, "mesh payload engine")
    worst = 0.0
    for i, p in enumerate(payloads):
        if got[i].error_code != ERR_OK:
            raise AssertionError(f"mesh payload {i}: error {got[i].error_code}")
        worst = max(worst, _check_close(got[i].scores, _forward(model, params, p, device),
                                        f"mesh payload {i}"))
    prog = check_programs(device, eng, model, params, "rm1 2x2 payload engine")
    k1 = _bucket_windows(device, cfg, eng.params, eng.buckets, "rm1 2x2 payload engine", errs)
    _log(f"[16 mesh] rm1 engine on a 2x2 mesh of one card (buckets {eng.buckets}), ragged "
         f"accepted: {_mesh_programs_line(eng)}; every program's first replay within bf16_atol "
         f"of model.apply on its rows (max |err| {prog:.3e}, replay against the engine's own "
         f"eager run {max((p.warm_err or 0.0) for p in eng.programs):.3e}); payloads "
         f"of 32, 17, 100 rows and a ragged one of 64 match model.apply (max |err| "
         f"{worst:.3e}, limit bf16_atol); launches {_nonzero(counts)} for {ex} executions "
         f"({eng.warmup_executions} at warm-up), {tally}; window K1 at each bucket's slice max "
         f"|err| {k1:.3e} against its plain version [{card}]")
    return max(worst, prog), counts


def mesh_serving(device, fwd: dict, single: dict, card: str, errs: dict) -> tuple[dict, dict]:
    """rm1 (phase 5's params) through ``run_serving`` with one engine on each
    of ``MESH_SERVING_AXES``' meshes of the card at the canonical point, its
    programs captured, beside phase 6's single-device engine and the eager
    2x2 engine (``MESH_EAGER_2X2``); each program's first replay held to
    ``model.apply`` on its warm rows; the window K1 at the engine's buckets
    held to its plain version."""
    cfg = fwd["cfg"]
    scfg = ServingConfig(**SERVING_POINT, num_batches=SERVE_QUERIES,
                         engine_backend=_backend(device))
    out, launches = {}, _want()
    for D, M in MESH_SERVING_AXES:
        label = f"{D}x{M}"
        _reset_peak(device)
        _reset_counts()
        with _engines_of_runs() as engines:
            res = run_serving(cfg, scfg, settle_s=0.1, params=fwd["params"],
                              mesh=_cuda_mesh(device, D, M))
        counts = _counts()
        (eng,) = engines
        if res.engine_errors or res.error_responses or res.num_responses != res.cpu_sub_requests:
            raise AssertionError(f"mesh serving {label}: {res.num_responses} responses for "
                                 f"{res.cpu_sub_requests}, errors {res.error_responses} "
                                 f"{res.engine_errors}")
        _mesh_launch_check(counts, _want(embedding_bag_shard=D * M * res.executions),
                           f"mesh serving {label} ({res.executions} executions)")
        tally = _mesh_tally(device, eng, {"embedding_bag_shard": D * M},
                            f"mesh serving {label}")
        peak = _peak_gib(device)
        prog = check_programs(device, eng, fwd["model"], fwd["params"],
                              f"rm1 {label} served engine")
        k1 = _bucket_windows(device, cfg, eng.params, eng.buckets,
                             f"rm1 {label} served engine", errs)
        eager = MESH_EAGER_2X2
        _log(f"[16 mesh] rm1 served by one engine on a {label} mesh of one card (virtual "
             f"shards), its programs captured, canonical point: {_served_line(res, counts)}; "
             f"{_mesh_programs_line(eng)}; {tally}; every program's first replay within "
             f"bf16_atol of model.apply on its rows (max |err| {prog:.3e}); peak {peak:.3f} "
             f"GiB; window K1 at each bucket's slice max |err| {k1:.3e}; beside phase 6's "
             f"single-device engine: QPS {single['measured_qps']:.2f}, p50/p95/p99 "
             f"{single['p50_ms']:.3f}/{single['p95_ms']:.3f}/{single['p99_ms']:.3f} ms; and "
             f"the eager 2x2 engine (PERF.md section 5): QPS {eager['measured_qps']:.2f}, p95 "
             f"{eager['p95_ms']:.3f} ms [{card}]")
        out[label] = {**res.to_dict(), "peak_gib": peak, "programs": len(eng.programs),
                      "captures": eng.graph_captures, "capture_ms": eng.capture_ms,
                      "pool_bytes": eng.graph_pool_bytes, "program_err": prog}
        _add(launches, counts)
        del engines, eng
        _free(device)
    return out, launches


def mesh_reload(device, fwd: dict, ckpt: Path, new_params: dict, card: str,
                errs: dict) -> tuple[dict, dict]:
    """The reload of phase 14's checkpoint into an rm1 engine on a 2x2 mesh
    of the card, behind the HTTP ingress, while two clients keep sending
    predicts: 0 failed requests, the programs captured again against the
    new shards (each first replay held to ``model.apply`` with the new
    params), then the new params' scores; the window K1 at the engine's
    bucket on the reloaded shards held to its plain version."""
    cfg, model = fwd["cfg"], fwd["model"]
    scfg = ServingConfig(engine_backend=_backend(device), batch_buckets=(32,),
                         max_mini_batch_size=32, sub_task_batch_size=32)
    probe = RecDataGenerator(cfg, seed=12).generate_batch(32)
    _reset_peak(device)
    _reset_counts()
    server = ServingServer(cfg, scfg, params=fwd["params"], mesh=_cuda_mesh(device, 2, 2))
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        eng = server.engines[0]
        first = eng.programs
        r = _reload_under_traffic(server, base, _body(probe), ckpt)
        del r["at_swap"]
        _, after = _http(f"{base}/v1/predict", _body(probe))
        counts = _counts()
        ex = _executions(eng)
        peak = _peak_gib(device)  # before the checks' plain versions allocate
        if eng.programs is first:
            raise AssertionError("mesh reload: the programs were not built again")
        tally = _mesh_tally(device, eng, {"embedding_bag_shard": 4}, "mesh reload")
        prog = check_programs(device, eng, model, new_params, "rm1 2x2 engine after its reload")
        k1 = _bucket_windows(device, cfg, eng.params, eng.buckets,
                             "rm1 2x2 engine after its reload", errs)
    finally:
        ing.stop()
    _mesh_launch_check(counts, _want(embedding_bag_shard=4 * ex), f"mesh reload ({ex} executions)")
    err = _check_close(after["scores"], _forward(model, new_params, probe, device),
                       "mesh /v1/predict after the reload")
    _log(f"[16 mesh] reload of {ckpt.name} into a 2x2-mesh engine under {FABRIC_CLIENTS} "
         f"clients: 0 failed of {r['answered']} answered; applied in {r['apply_ms']:.1f} ms "
         f"(loaded on the card, sharded into views, {len(eng.programs)} programs captured "
         f"again in {eng.programs.capture_ms:.1f} ms, graph pool "
         + ("not measured" if eng.graph_pool_bytes is None
            else f"{eng.graph_pool_bytes / 2**20:.1f} MiB")
         + f"); each first replay within bf16_atol of model.apply with the new params (max "
         f"|err| {prog:.3e}); then the new params' scores (max |err| {err:.3e}); {tally}; "
         f"window K1 on the reloaded shards max |err| {k1:.3e}; peak {peak:.3f} GiB; launches "
         f"{_nonzero(counts)} for {ex} executions [{card}]")
    recapture_ms = eng.programs.capture_ms
    del eng, first
    _free(device)
    return {**r, "peak_gib": peak, "max_abs_err": max(err, prog),
            "recapture_ms": recapture_ms}, counts


def mesh_refresh(device, card: str, errs: dict) -> tuple[dict, dict]:
    """Zipf(1.2) payloads through an rm1 hot/cold engine with refresh
    tracking on a 1x4 mesh of the card, its programs (each mesh cold rung
    and the direct lookup of each bucket) captured and, before any payload,
    each first replay held to the eager forward on its warm rows
    (``check_programs``; its launches are taken out of the path's): it must
    upgrade its hot set, the new hot rows gathered from the shards that own
    them and written into the hot table its programs read (the same
    tensor), and every payload's scores match the direct model (bf16_atol);
    then, at each of the engine's buckets, K6 on every shard (zipf ids, the
    new hot set) and the window K1 held to their plain versions."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", embedding_impl="hotcold",
                         hot_set_rows=REFRESH_HOT_ROWS)
    model = get_model(cfg.replace(embedding_impl="xla"), device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device),
                         hotcold_refresh_interval=REFRESH_INTERVAL, hotcold_refresh_window=8)
    rng = np.random.default_rng(19)
    mesh = _cuda_mesh(device, 1, MESH_SHARDS)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    _reset_counts()
    eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, params=params, mesh=mesh)
    eng.start()
    ready = ready_q.get(timeout=300)
    if isinstance(ready, Exception):
        raise RuntimeError("the mesh refresh engine failed during setup") from ready
    table = eng.params.entry(0, 0)["hot_table"]
    pre = _counts()
    prog = check_programs(device, eng, model, params, f"rm1 1x{MESH_SHARDS} hot/cold engine")
    checked = {k: v - pre[k] for k, v in _counts().items()}
    warm_cov, answered, after = eng.hot_coverage, [], 0
    while len(answered) < REFRESH_MAX_PAYLOADS and after < 2 * REFRESH_INTERVAL:
        n = len(answered)
        p = Batch(dense=rng.random((64, cfg.dense_dim), dtype=np.float32),
                  indices=zipf_stream(cfg, 64, seed=300 + n))
        req_q.put(ServiceRequest(batch_id=n, batch_size=64, arrival_time=time.time(),
                                 payload=p))
        answered.append((p, resp_q.get(timeout=120)))
        after += eng.hot_refreshes > 0
    req_q.put(None)
    eng.join(timeout=120)
    counts = {k: v - checked[k] for k, v in _counts().items()}
    ex = _executions(eng)
    k6, k1 = counts["embedding_bag_hotcold_shard"], counts["embedding_bag_shard"]
    if eng.error is not None or eng.hot_refreshes < 1:
        raise AssertionError(f"mesh refresh: {eng.hot_refreshes} refreshes, error {eng.error!r}")
    if k6 == 0 or k6 + k1 != MESH_SHARDS * ex or counts != _want(
            embedding_bag_hotcold_shard=k6, embedding_bag_shard=k1):
        raise AssertionError(f"mesh refresh: launches {counts} for {ex} executions")
    hot = eng.params.entry(0, MESH_SHARDS - 1)["hot_table"]
    if hot is not table or not torch.equal(hot, params["tables"].index_select(
            0, torch.as_tensor(np.asarray(eng._hotcold.hot_ids), device=device))):
        raise AssertionError("mesh refresh: the programs' hot table does not hold the tables' "
                             f"hot rows (the same tensor: {hot is table})")
    tally = _mesh_tally(device, eng, lambda key: {
        "embedding_bag_hotcold_shard" if key[0] == "hotcold" else "embedding_bag_shard":
        MESH_SHARDS}, "mesh refresh")
    worst = max(_check_close(r.scores, _forward(model, params, p, device), f"mesh refresh {n}")
                for n, (p, r) in enumerate(answered))
    hc = make_hotcold_model(model, np.asarray(eng._hotcold.hot_ids), mesh=mesh)
    k6 = max(_hotcold_cells("none", eng.params,
                            hc.prepare(Batch(dense=None, indices=zipf_stream(cfg, n, seed=400 + n))),
                            f"rm1 1x{MESH_SHARDS} hot/cold engine bucket {n}", errs)
             for n in eng.buckets)
    k1 = _bucket_windows(device, cfg, eng.params, eng.buckets,
                         f"rm1 1x{MESH_SHARDS} hot/cold engine's direct path", errs)
    rungs = sorted({p.key[2] for p in eng.programs if p.key[0] == "hotcold"})
    _log(f"[16 mesh] rm1 hot/cold engine with refresh on a 1x{MESH_SHARDS} mesh of one card "
         f"(mesh cold rungs {rungs}): {_mesh_programs_line(eng)}; every program's first "
         f"replay within bf16_atol of the eager forward on its rows (max |err| {prog:.3e}); "
         f"{len(answered)} zipf(1.2) payloads of 64 rows; warm-up coverage {warm_cov:.4f}, "
         f"hot_refreshes {eng.hot_refreshes}, hot_coverage {eng.hot_coverage:.4f}; the new hot "
         f"rows (the shards') written into the programs' own hot table, the same tensor; "
         f"scores match the direct model (max |err| {worst:.3e}); launches {_nonzero(counts)} "
         f"for {ex} executions, {tally}; at each "
         f"bucket K6 max |err| {k6:.3e} and window K1 {k1:.3e} against their plain versions "
         f"[{card}]")
    del params, eng, table, hot
    _free(device)
    return {"payloads": len(answered), "hot_refreshes": 1, "max_abs_err": max(worst, prog)}, \
        counts


@contextlib.contextmanager
def _eager_engines():
    """Engines built inside the block keep their programs eager (phase 16's
    eager arm): the engines' rule gives them a reason."""
    from deeprecsys_tpu_torch.serving import engine as engine_module

    orig = engine_module.eager_reason
    engine_module.eager_reason = lambda mesh: "the eager arm of chip_smoke.py's phase 16"
    try:
        yield
    finally:
        engine_module.eager_reason = orig


def _card_launches(eng) -> dict:
    """A graphed engine's launches by card index over its run: each
    program's tally on that card times its eager warm run, its warm replay
    and its served replays."""
    out: dict = {}
    for p in eng.programs:
        for dev, tally in p.stage_launches:
            out[dev.index] = out.get(dev.index, 0) + sum(tally.values()) * (p.runs + 2)
    return out


def mesh_cards(device, fwd: dict, card: str, errs: dict) -> tuple[dict, dict]:
    """rm1 (phase 5's params) through ``run_serving`` with one engine over
    each of ``MESH_CARDS_AXES``' meshes of distinct cards the machine holds,
    at the canonical point: graphed (a graph a card's part a program), the
    same engine with its programs eager, and the same mesh of card 0's
    virtual shards (graphed, one graph a program). Each run answers every
    sub-request with D*M window K1 launches an execution; each graphed
    engine's programs hold to ``model.apply`` on their warm rows
    (``check_programs``), the window K1 at its buckets on each card to its
    plain version. With one card, one line says that this part did not
    run. Returns the results by mesh and arm, and the launches."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 2:
        _log(f"[16 mesh cards] the engines over several cards need two cards or more; this "
             f"machine has {n}: not run [{card}]")
        return {}, _want()
    cfg = fwd["cfg"]
    scfg = ServingConfig(**SERVING_POINT, num_batches=SERVE_QUERIES,
                         engine_backend=_backend(device))
    cards = [torch.device("cuda", i) for i in range(n)]
    out, launches = {}, _want()
    for D, M in MESH_CARDS_AXES:
        if D * M > n:
            continue
        label = f"{D}x{M}"
        out[label] = {}
        for arm, devices in (("one card", [device] * (D * M)), ("graphed", cards[:D * M]),
                             ("eager", cards[:D * M])):
            what = f"rm1 {label} over {'one card' if arm == 'one card' else f'{D * M} cards'}"
            for c in cards:
                _reset_peak(c)
            _reset_counts()
            with _engines_of_runs() as engines, (
                    _eager_engines() if arm == "eager" else contextlib.nullcontext()):
                res = run_serving(cfg, scfg, settle_s=0.1, params=fwd["params"],
                                  mesh=make_mesh(D, M, devices=devices))
            counts = _counts()
            (eng,) = engines
            if (res.engine_errors or res.error_responses
                    or res.num_responses != res.cpu_sub_requests):
                raise AssertionError(f"{what} ({arm}): {res.num_responses} responses for "
                                     f"{res.cpu_sub_requests}, errors {res.error_responses} "
                                     f"{res.engine_errors}")
            _mesh_launch_check(counts, _want(embedding_bag_shard=D * M * res.executions),
                               f"{what} ({arm}, {res.executions} executions)")
            peak = max(_peak_gib(c) for c in cards[:D * M])
            row = {**res.to_dict(), "peak_gib": peak, "programs": len(eng.programs),
                   "captures": eng.graph_captures, "capture_ms": eng.capture_ms}
            if arm == "eager":
                if eng.graph_captures or any(p.graphs for p in eng.programs):
                    raise AssertionError(f"{what}: the eager arm captured")
                detail = f"{len(eng.programs)} programs, eager"
            else:
                tally = _mesh_tally(device, eng, {"embedding_bag_shard": D * M},
                                    f"{what} ({arm})")
                prog = check_programs(device, eng, fwd["model"], fwd["params"], what)
                warm = max((p.warm_err or 0.0) for p in eng.programs)
                parts = {len(p.graphs) for p in eng.programs}
                by_card = {f"cuda:{i}": b for i, b in sorted(eng.graph_pool_bytes_by_card.items())}
                per_card = _card_launches(eng)
                row.update(program_err=prog, warm_err=warm, graphs_a_program=sorted(parts),
                           pool_bytes=eng.graph_pool_bytes, pool_bytes_by_card=by_card,
                           launches_by_card=per_card)
                detail = (f"{len(eng.programs)} programs, {sorted(parts)} graphs each (a graph "
                          f"a card's part), {eng.graph_captures} programs captured in "
                          f"{eng.capture_ms:.1f} ms ({eng.capture_ms / len(eng.programs):.2f} ms "
                          f"a program); graph pool by card "
                          f"{ {k: f'{v / 2**20:.1f} MiB' for k, v in by_card.items()} }; "
                          f"window K1 launches by card {per_card}; {tally}; every first "
                          f"replay within bf16_atol of model.apply on its rows (max |err| "
                          f"{prog:.3e}), against the engine's own eager run {warm:.3e}")
                if arm == "graphed":
                    k1 = _bucket_windows(device, cfg, eng.params, eng.buckets, what, errs)
                    detail += f"; window K1 at each bucket's slice on each card max |err| {k1:.3e}"
            _log(f"[16 mesh cards] {what}, {arm}, canonical point: {_served_line(res, counts)}; "
                 f"{detail}; peak {peak:.3f} GiB [{card}]")
            _log(f"[16 mesh cards] {label} {arm}: QPS {res.measured_qps:.2f} [{card}; "
                 f"{D * M if arm != 'one card' else 1} card(s)]")
            _log(f"[16 mesh cards] {label} {arm}: p95 {res.p95_ms:.3f} ms [{card}; "
                 f"{D * M if arm != 'one card' else 1} card(s)]")
            out[label][arm] = row
            _add(launches, counts)
            del engines, eng
            _free(device)
    out["paths"], counts = mesh_cards_paths(device, cards, card, errs)
    _add(launches, counts)
    return out, launches


def _payloads(cfg, impl: str, rng) -> list:
    """A cards engine's first payloads: 32, 100 and a ragged 64 rows of the
    generator's ids (a direct engine), or 64 rows of zipf(1.2) ids."""
    if impl == "hotcold":
        return [Batch(dense=rng.random((64, cfg.dense_dim), dtype=np.float32)
                      if cfg.dense_dim else None, indices=zipf_stream(cfg, 64, seed=500 + n))
                for n in range(REFRESH_MAX_PAYLOADS)]
    data = RecDataGenerator(cfg, seed=41)
    rag = data.generate_batch(64)
    return [data.generate_batch(32), data.generate_batch(100),
            rag._replace(mask=rng.random(rag.indices.shape) < 0.6)]


def mesh_cards_paths(device, cards: list, card: str, errs: dict) -> tuple[dict, dict]:
    """Over the largest mesh of distinct cards (2x2 on four cards, else
    1x2), each engine's programs a graph a card's part, at the canonical
    ladder: rm1 with per-table and with row-wise int8 tables served direct,
    ragged accepted (K1-int8's and K4's windows); rm1 hot/cold with refresh
    in the three layouts on zipf(1.2) payloads (K6 on a shard, the direct
    windows beside, until a refresh and 2 x REFRESH_INTERVAL payloads after
    it; the scans inline, so that the refresh comes at the same payload on
    every run); dien (K3 in each data row's tail, on that row's first card). Each
    engine's payloads are held to ``model.apply`` (bf16_atol), each first
    replay to the reference (``check_programs``, its launches taken out of
    the path's), the path's launches to its executions times the tally, and
    the path's kernel on every cell at each bucket, on its own card, to its
    plain version."""
    D, M = (2, 2) if len(cards) >= 4 else (1, 2)
    mesh = make_mesh(D, M, devices=cards[:D * M])
    runs = ([("rm1", q, "xla") for q in QUANT_MODES]
            + [("rm1", q, "hotcold") for q in ("none",) + QUANT_MODES] + [("dien", "none", "xla")])
    out, launches = {}, _want()
    rng = np.random.default_rng(43)
    for name, quant, impl in runs:
        what = f"{name} {quant} tables {impl}, {D}x{M} over {D * M} cards"
        cfg = zoo.get_config(name, table_scale=TABLE_SCALE, param_dtype="bfloat16",
                             compute_dtype="bfloat16", table_quant=quant, embedding_impl=impl,
                             hot_set_rows=REFRESH_HOT_ROWS)
        model = get_model(cfg.replace(embedding_impl="xla"), device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        _reset_counts()  # K3 launches a forward (dien's scans), from one forward
        _forward(model, params, RecDataGenerator(cfg, seed=3).generate_batch(8), device)
        k3_a_forward = _counts()["rnn_scan"]
        scfg = ServingConfig(**SERVING_POINT, engine_backend=_backend(device),
                             accept_ragged=impl == "xla",
                             hotcold_refresh_interval=REFRESH_INTERVAL if impl == "hotcold" else 0,
                             hotcold_refresh_window=8, hotcold_scan_async=False)
        req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        _reset_counts()
        eng = ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, params=params, mesh=mesh)
        eng.start()
        ready = ready_q.get(timeout=600)
        if isinstance(ready, Exception):
            raise RuntimeError(f"{what}: the engine failed during setup") from ready
        pre = _counts()
        prog = check_programs(device, eng, model, params, what)
        checked = {k: v - pre[k] for k, v in _counts().items()}
        answered, after = [], 0
        for n, p in enumerate(_payloads(cfg, impl, rng)):
            req_q.put(ServiceRequest(batch_id=n, batch_size=len(p.indices),
                                     arrival_time=time.time(), payload=p))
            answered.append((p, resp_q.get(timeout=120)))
            after += eng.hot_refreshes > 0
            if impl == "hotcold" and after >= 2 * REFRESH_INTERVAL:
                break
        req_q.put(None)
        eng.join(timeout=120)
        counts = {k: v - checked[k] for k, v in _counts().items()}
        ex = _executions(eng)
        if eng.error is not None or (impl == "hotcold" and eng.hot_refreshes < 1):
            raise AssertionError(f"{what}: {eng.hot_refreshes} refreshes, error {eng.error!r}")
        k3 = k3_a_forward * D * ex  # a forward's scans in each data row's tail
        if impl == "hotcold":
            k6, k1 = counts[HOTCOLD_SHARD[quant]], counts[SHARD[quant]]
            if k6 == 0 or k6 + k1 != D * M * ex:
                raise AssertionError(f"{what}: launches {counts} for {ex} executions")
            want = _want(**{HOTCOLD_SHARD[quant]: k6, SHARD[quant]: k1})
        else:
            want = _want(**{SHARD[quant]: D * M * ex}, rnn_scan=k3)
        _mesh_launch_check(counts, want, f"{what} ({ex} executions)")

        def tally(key):
            t = {(HOTCOLD_SHARD if key[0] == "hotcold" else SHARD)[quant]: D * M}
            return {**t, "rnn_scan": k3_a_forward * D} if k3_a_forward else t

        line = _mesh_tally(device, eng, tally, what)
        worst = 0.0
        for n, (p, r) in enumerate(answered):
            if r.error_code != ERR_OK:
                raise AssertionError(f"{what}: payload {n} error {r.error_code}")
            worst = max(worst, _check_close(r.scores, _forward(model, params, p, device),
                                            f"{what} payload {n}"))
        cells = _bucket_windows(device, cfg, eng.params, eng.buckets, what, errs, quant)
        if impl == "hotcold":
            hc = make_hotcold_model(model, np.asarray(eng._hotcold.hot_ids), mesh=mesh)
            cells = max(cells, max(
                _hotcold_cells(quant, eng.params, hc.prepare(Batch(
                    dense=None, indices=zipf_stream(cfg, n, seed=400 + n))),
                    f"{what} bucket {n}", errs) for n in eng.buckets))
        by_card = {f"cuda:{i}": b for i, b in sorted(eng.graph_pool_bytes_by_card.items())}
        _log(f"[16 mesh cards] {what}: {len(eng.programs)} programs, "
             f"{sorted({len(p.graphs) for p in eng.programs})} graphs each, captured in "
             f"{eng.capture_ms:.1f} ms; graph pool by card "
             f"{ {k: f'{v / 2**20:.1f} MiB' for k, v in by_card.items()} }; every first replay "
             f"within bf16_atol of the reference (max |err| {prog:.3e}, against the engine's "
             f"own eager run {max((p.warm_err or 0.0) for p in eng.programs):.3e}); "
             f"{len(answered)} payloads match model.apply (max |err| {worst:.3e})"
             + (f", hot_refreshes {eng.hot_refreshes}" if impl == "hotcold" else "")
             + f"; launches {_nonzero(counts)} for {ex} executions, {line}; launches by card "
             f"{_card_launches(eng)}; each cell's kernel at each bucket against its plain "
             f"version max |err| {cells:.3e} [{card}]")
        out[what] = {"programs": len(eng.programs), "max_abs_err": max(worst, prog),
                     "capture_ms": eng.capture_ms, "pool_bytes_by_card": by_card,
                     "launches_by_card": _card_launches(eng)}
        _add(launches, counts)
        del eng, params, model
        _free(device)
    return out, launches


def phase_mesh(device, fwd: dict, times: dict, single: dict, card: str,
               errs: dict) -> tuple[dict, dict]:
    """Phase 16 (but its zoo models, run in phase 8's loop, and its reload,
    in phase 14's): serving over meshes of the card, each path read around
    itself. ``errs``: each kernel's max |error| against its plain version so
    far, which the paths raise. Returns the results and the launches."""
    t0 = time.perf_counter()
    launches = _want()
    out = {"errs": errs, "times": {}}
    for seed, name in enumerate(MESH_KERNEL_MODELS):
        case_errs, ktimes = mesh_kernel_cases(device, name, seed, card)
        for k, v in case_errs.items():
            _merge(errs, k, v)
        out["times"].setdefault(name, ktimes)
    for key, run in (("rm1", lambda: mesh_rm1(device, fwd, times, card, errs)),
                     ("layouts", lambda: mesh_layouts(device, fwd, card, errs)),
                     ("payload_err", lambda: mesh_engine_payloads(device, fwd, card, errs)),
                     ("serving", lambda: mesh_serving(device, fwd, single, card, errs)),
                     ("refresh", lambda: mesh_refresh(device, card, errs))):
        out[key], counts = run()
        _add(launches, counts)
    _log(f"[16 mesh] phase 16 (but its zoo models and reload) in "
         f"{time.perf_counter() - t0:.1f} s")
    return out, launches


# ------------------------------------------------------- 17 mesh training

class _Recorder:
    """A kernel wrapper that records its calls as ``(args, kwargs,
    before(*args), result)`` and runs the wrapper; with ``after``, the
    result recorded is ``after(args, kwargs, out)``: a check made at the
    call, before the step goes on to change what the call read. A call
    that a serving engine makes while it captures a CUDA graph launches
    nothing (each replay does, held to the eager forward in phase 6) and
    may not synchronize: it runs unrecorded. Its ``kernel_launches`` is
    the wrapper's own (a wrapper counts itself through its module's name,
    which then names this)."""

    def __init__(self, orig, before, after):
        self.orig, self.before, self.after, self.calls = orig, before, after, []

    def __call__(self, *args, **kwargs):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return self.orig(*args, **kwargs)
        pre = self.before(*args) if self.before is not None else None
        out = self.orig(*args, **kwargs)
        self.calls.append((args, kwargs, pre,
                           out if self.after is None else self.after(args, kwargs, out)))
        return out

    @property
    def kernel_launches(self):
        return self.orig.kernel_launches

    @kernel_launches.setter
    def kernel_launches(self, value):
        self.orig.kernel_launches = value


@contextlib.contextmanager
def _recorded(module, name: str, before=None, after=None):
    """The calls of ``module.<name>`` (a kernel wrapper or helper, where the
    path looks it up) recorded (``_Recorder``); the wrapper itself runs, and
    counts its launch, as always."""
    orig = getattr(module, name)
    rec = _Recorder(orig, before, after)
    setattr(module, name, rec)
    try:
        yield rec.calls
    finally:
        setattr(module, name, orig)


def _k5_pre(*args):
    return args[0].clone(), args[1].clone()


def _k1_window_err(what: str):
    """An ``after`` for ``embedding_bag_shard``: the partial K1's window
    returned against ``embedding_bag_reference(..., window=)`` on the same
    shard and ids, within ``pooled_tolerance`` of the window (the order of
    the L adds). Returns the max |err|."""
    def check(args, kw, out):
        shard, offsets, indices, row_lo = args[:4]
        mask, w = kw.get("mask"), (row_lo, row_lo + shard.shape[0])
        cdt = kw.get("compute_dtype")
        with torch.no_grad():
            got = out.detach()
            want = embedding_bag_reference(shard, offsets, indices, mask=mask, window=w,
                                           compute_dtype=shard.dtype if cdt is None else cdt)
            err = (got.float() - want.float()).abs()
            tol = pooled_tolerance(got, want, shard, offsets, indices, mask, window=w)
        if not bool((err <= tol).all()):
            raise AssertionError(f"K1's window disagrees with its plain version ({what}, rows "
                                 f"[{w[0]}, {w[1]}), b={indices.shape[0]}): max |err| "
                                 f"{err.max().item():.3e}, {int((err > tol).sum())} over")
        return err.max().item()

    return check


def _int8_window_err(quant: str, what: str):
    """An ``after`` for K1-int8's (``quant`` "int8") or K4's window
    (``SHARD[quant]``): the partial against its plain version with the
    window on the same shard and ids, as ``_check_partial`` holds it
    (int32 bit for bit; K4 within ``rowwise_tolerance`` of the window).
    Returns the max |err|."""
    def check(args, kw, out):
        shard, offsets, indices, row_lo = args[:4]
        mask, w = kw.get("mask"), (row_lo, row_lo + shard.shape[0])
        want = _window_partial(quant, shard, offsets, indices, row_lo, mask, plain=True)
        return _check_partial(
            quant, out, want, shard, f"{what}: rows [{w[0]}, {w[1]}), b={indices.shape[0]}",
            lambda a, b, t: rowwise_tolerance(a, b, t, offsets, indices, mask, window=w))

    return check


def _check_k1b_windows(calls, what: str) -> float:
    """Each recorded K1b window launch against its plain version, within
    ``backward_tolerance`` of the window (the order of each row's adds)."""
    worst = 0.0
    for args, kw, _, got in calls:
        g, offsets, indices, row_lo, rows = args
        mask, w = kw.get("mask"), (row_lo, row_lo + rows)
        err = (got - embedding_bag_backward_reference(g, offsets, indices, rows, mask=mask,
                                                      window=w)).abs()
        tol = backward_tolerance(g, offsets, indices, rows, mask, window=w)
        if not bool((err <= tol).all()):
            raise AssertionError(f"K1b's window disagrees with its plain version ({what}, rows "
                                 f"[{w[0]}, {w[1]}), b={indices.shape[0]}): max |err| "
                                 f"{err.max().item():.3e}, {int((err > tol).sum())} over")
        worst = max(worst, err.max().item())
        del err, tol
    return worst


def _k5_call(args, window: bool):
    """``(table, acc, offsets, ids, g, lr, eps, window)`` of a recorded K5
    call, positional as the trainer makes it: the window's ``(shard, acc,
    offsets, ids, g, row_lo, lr, eps)`` or the direct kernel's ``(table,
    acc, offsets, ids, g, lr, eps)`` (window None)."""
    if window:
        shard, acc, offsets, ids, g, row_lo, lr, eps = args
        return shard, acc, offsets, ids, g, lr, eps, (row_lo, row_lo + shard.shape[0])
    table, acc, offsets, ids, g, lr, eps = args
    return table, acc, offsets, ids, g, lr, eps, None


def _k5_ref(t0, a0, offsets, ids, g, lr, eps, w):
    t, a = t0.clone(), a0.clone()
    sparse_adagrad_step_reference(t, a, offsets, ids, g, lr, eps, window=w)
    return t, a


def _check_k5(calls, what: str, window: bool) -> float:
    """Each recorded K5 launch (the window's with ``window``, else the
    direct kernel's), recorded with ``_k5_pre``: the table and accumulator
    it left against the plain version from the state before it, within
    ``sparse_adagrad_tolerance``. Run before the next step."""
    worst = 0.0
    for args, _, (t0, a0), _ in calls:
        table, acc, offsets, ids, g, lr, eps, w = _k5_call(args, window)
        want_t, want_a = _k5_ref(t0, a0, offsets, ids, g, lr, eps, w)
        tol, acc_tol = sparse_adagrad_tolerance(t0, a0, offsets, ids, g, lr, eps, window=w)
        err, acc_err = (table.float() - want_t.float()).abs(), (acc - want_a).abs()
        if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
            where = "the whole table" if w is None else f"rows [{w[0]}, {w[1]})"
            raise AssertionError(f"K5{'s window' if window else ''} disagrees with its plain "
                                 f"version ({what}, {where}, ids {tuple(ids.shape)}): max "
                                 f"|err| table {err.max().item():.3e}, acc "
                                 f"{acc_err.max().item():.3e}")
        worst = max(worst, err.max().item(), acc_err.max().item())
        del want_t, want_a, tol, acc_tol, err, acc_err
    return worst


def _without_pre(calls) -> list:
    """Recorded calls with the ``before`` copies dropped (they hold a table)."""
    return [(args, kw, None, out) for args, kw, _, out in calls]


def _check_pooled_grad(g_m, g_s, delta: float, what: str) -> float:
    """The mesh's pooled gradient (rows in data-row order) against the
    single-device one's on the same rows: within ``delta`` (MESH_G_RTOL of
    the single-device max |g|, the f32 rounding of the towers' backward
    on a slice and on the batch). Returns the max |diff|."""
    diff = (g_m.float() - g_s.float().to(g_m.device)).abs().max().item()
    if not diff <= delta:
        raise AssertionError(f"{what}: the mesh's pooled gradient differs from the "
                             f"single-device one by {diff:.3e}, past {MESH_G_RTOL:.0e} of its "
                             f"max |g| ({delta:.3e})")
    return diff


def _check_slices_grad(g_s, s_ids, mesh_calls, delta: float, what: str) -> float:
    """``_check_pooled_grad`` of each recorded K1b window call's pooled
    gradient against the single-device rows of its data slice (the slice
    whose ids it was given)."""
    worst = 0.0
    for args, _, _, _ in mesh_calls:
        g, ids = args[0], args[2]
        b = ids.shape[0]
        d = next((d for d in range(s_ids.shape[0] // b)
                  if torch.equal(ids, s_ids[d * b:(d + 1) * b].to(ids.device))), None)
        if d is None:
            raise AssertionError(f"{what}: a K1b window call's ids are no data slice of the batch")
        worst = max(worst, _check_pooled_grad(g, g_s[d * b:(d + 1) * b], delta, what))
    return worst


def _dedup_limit(ded_s, ded_m, delta: float, what: str):
    """The recorded ``_dedup_stream`` calls of the single-device and the
    mesh's dedup step (their pooled gradients within ``delta``, checked
    before): the unique rows the same, and each merged gradient within
    n * delta + n^2 * 2^-23 * max |g| of the single-device one for a row of
    n slots (the slots' differences, and each side's f32 sum of n terms of
    at most max |g|). Returns that limit as a ``(N, 1, 1)`` tensor and the
    max |diff|."""
    off, ids, g = ded_s[0]
    _, uids_s, sum_s = ded_s[3]
    _, uids_m, sum_m = ded_m[3]
    if not torch.equal(uids_m.to(uids_s.device), uids_s):
        raise AssertionError(f"{what}: the mesh's unique rows differ from the single-device ones")
    flat = (ids.long() + off.long()[None, :, None]).reshape(-1)
    _, counts = torch.unique(flat, return_counts=True)  # ascending, as dedup's head
    n = torch.zeros((uids_s.shape[0],), dtype=torch.float32, device=g.device)
    n[:counts.shape[0]] = counts.float()
    lim = (n * (delta + n * 2.0 ** -23 * g.abs().max())).reshape(-1, 1, 1)
    diff = (sum_m.float().to(sum_s.device) - sum_s.float()).abs()
    if not bool((diff <= lim).all()):
        raise AssertionError(f"{what}: the mesh's merged gradients differ from the single-device "
                             f"ones by {diff.max().item():.3e}, past n * delta + rounding")
    return lim, diff.max().item()


def _k5_carry(t0, a0, offsets, ids, g, delta, lr: float, eps: float, w):
    """How far K5's step from ``(t0, a0)`` on window ``w``'s rows can move,
    in exact arithmetic, when each element of ``g`` moves by at most
    ``delta`` (a float, or a tensor that broadcasts to ``g``). Returns
    ``(rows, table (U, d), acc (U,))`` on the U rows the window's slots
    touch. A row of slots s takes acc = a0 + sum_s mean(g_s^2), which moves
    by at most eA = sum_s mean(2 |g_s| delta_s + delta_s^2), and the update
    -lr * (sum_s g_s) * rsqrt(acc + eps), whose sum moves by at most nD =
    sum_s delta_s; so the update moves by at most lr * ((|sum_s g_s| + nD)
    * (rsqrt(max(acc - eA, 0) + eps) - rsqrt(acc + eps)) + nD * rsqrt(acc +
    eps))."""
    B, T, L = ids.shape
    d = g.shape[-1]
    flat, valid = window_ids(offsets, ids, None, w)
    dl = torch.broadcast_to(torch.as_tensor(delta, dtype=torch.float32, device=g.device), g.shape)
    g_rows = g.float()[:, :, None, :].expand(B, T, L, d).reshape(-1, d)
    dl_rows = dl[:, :, None, :].expand(B, T, L, d).reshape(-1, d)
    if valid is not None:
        keep = valid.reshape(-1)
        flat, g_rows, dl_rows = flat[keep], g_rows[keep], dl_rows[keep]
    rows, inv = torch.unique(flat, return_inverse=True)
    U = rows.shape[0]
    acc = a0[rows] + torch.zeros((U,), device=g.device).index_add_(0, inv, (g_rows ** 2).mean(-1))
    e_acc = torch.zeros((U,), device=g.device).index_add_(
        0, inv, (2 * g_rows.abs() * dl_rows + dl_rows ** 2).mean(-1))
    g_sum = torch.zeros((U, d), device=g.device).index_add_(0, inv, g_rows)
    n_delta = torch.zeros((U, d), device=g.device).index_add_(0, inv, dl_rows)
    r0 = torch.rsqrt(acc + eps)[:, None]
    r1 = torch.rsqrt(torch.clamp(acc - e_acc, min=0) + eps)[:, None]
    return rows, lr * ((g_sum.abs() + n_delta) * (r1 - r0) + n_delta * r0), e_acc


def _sparse_parity(single_call, mesh_calls, single, start_table, delta, what: str) -> float:
    """The mesh's table and accumulator after one sparse step against the
    single-device step's, shard by shard. Each side lies within its K5
    bound (``sparse_adagrad_tolerance``) of its plain version, and each
    plain version within the same bound of exact arithmetic on its own
    stream; the two streams' gradients differ by at most ``delta`` (held
    by the caller), which moves the exact step by at most ``_k5_carry``.
    Rows no slot touches stay as they were on both sides."""
    s_off, s_ids, s_g = single_call[0][2:5]
    worst = 0.0
    for args, _, _, _ in mesh_calls:
        shard, acc, offsets, ids, g, lr, eps, w = _k5_call(args, True)
        t0 = start_table[w[0]:w[1]]
        a0 = torch.zeros_like(acc)
        bound_t, bound_a = sparse_adagrad_tolerance(t0, a0, s_off, s_ids, s_g, lr, eps, window=w)
        tol_m, atol_m = sparse_adagrad_tolerance(t0, a0, offsets, ids, g, lr, eps, window=w)
        bound_t.add_(tol_m).mul_(2)
        bound_a.add_(atol_m).mul_(2)
        del tol_m, atol_m
        rows, carry_t, carry_a = _k5_carry(t0, a0, s_off, s_ids, s_g, delta, lr, eps, w)
        bound_t[rows] += carry_t
        bound_a[rows] += carry_a
        err = (shard.float() - single.params["tables"][w[0]:w[1]].float()).abs()
        acc_err = (acc - single.opt_state[1][w[0]:w[1]]).abs()
        if not (bool((err <= bound_t).all()) and bool((acc_err <= bound_a).all())):
            raise AssertionError(f"{what}: after one step the table (max |err| "
                                 f"{err.max().item():.3e}) or accumulator ({acc_err.max().item():.3e}) "
                                 f"of rows [{w[0]}, {w[1]}) is past K5's bounds and what the "
                                 f"pooled gradients' limit carries")
        worst = max(worst, err.max().item(), acc_err.max().item())
        del bound_t, bound_a, carry_t, carry_a, err, acc_err
    return worst


def _state_of(tr, tensor):
    """The adagrad accumulator of ``tensor`` in a trainer's state."""
    if tr.mesh is None:
        keys = list(bridge.flatten(tr.params))
        return tr.opt_state[keys.index("tables")]
    leaves = [t for c in leaf_copies(tr.params) for t in c]
    for dev, idx in tr.opt_state.devices.items():
        for j, i in enumerate(idx):
            if leaves[i] is tensor:
                return tr.opt_state.states[dev][j]
    raise AssertionError("no optimizer state for the table shard")


def _dense_parity(single_call, mesh_calls, table_s, table_of, state_s, state_of, table0,
                  delta: float, lr: float, optimizer: str, what: str) -> float:
    """The mesh's table gradient and the table (and adagrad state) after one
    dense step against the single-device step's, shard by shard. The
    gradients: each side within K1b's bound (``backward_tolerance``, the
    cells of a shard added) of exact arithmetic on its own pooled gradient,
    and those differ by at most ``delta`` (held by the caller), so a row of
    n slots by at most n * delta more: tol_g. The update is K10 on both
    sides (bit for bit its plain version), so the tables differ by at most
    lr * tol_g (sgd) or lr / sqrt(0.1) * tol_g (adagrad from its 0.1
    start), and the accumulators by (2 |G_s| + tol_g) * tol_g, plus the
    rounding of the update and the add on each side."""
    g_s, s_off, s_ids = single_call[0][:3]
    G_s = single_call[3]
    worst = 0.0
    for row_lo in sorted({args[3] for args, _, _, _ in mesh_calls}):
        cells = [c for c in mesh_calls if c[0][3] == row_lo]
        rows = cells[0][0][4]
        w = (row_lo, row_lo + rows)
        G_m = sum(c[3] for c in cells)
        tol_g = backward_tolerance(g_s, s_off, s_ids, rows, window=w)
        for c in cells:
            tol_g += backward_tolerance(c[0][0], c[0][1], c[0][2], rows, window=w)
        tol_g += delta * scatter_counts(s_off, s_ids, rows, window=w)[:, None]
        dG = (G_m - G_s[w[0]:w[1]]).abs()
        if not bool((dG <= tol_g).all()):
            raise AssertionError(f"{what}: the table gradient of rows [{w[0]}, {w[1]}) differs "
                                 f"from the single-device one by {dG.max().item():.3e}, past "
                                 f"K1b's bounds and what the pooled gradients' limit carries")
        t0 = table0[w[0]:w[1]].float()
        slack = 2.0 ** -20 * (t0.abs() + lr * (1.0 + G_s[w[0]:w[1]].abs()))
        gain = lr if optimizer == "sgd" else lr / np.sqrt(0.1)
        err = (table_of(row_lo).float() - table_s[w[0]:w[1]].float()).abs()
        if not bool((err <= gain * tol_g + slack).all()):
            raise AssertionError(f"{what}: after one step the table of rows [{w[0]}, {w[1]}) "
                                 f"differs from the single-device one by {err.max().item():.3e}, "
                                 f"past what its gradient's bound carries")
        worst = max(worst, err.max().item())
        if state_s is not None:
            acc_err = (state_of(row_lo) - state_s[w[0]:w[1]]).abs()
            bound = (2 * G_s[w[0]:w[1]].abs() + tol_g) * tol_g + 2.0 ** -22 * state_s[w[0]:w[1]]
            if not bool((acc_err <= bound).all()):
                raise AssertionError(f"{what}: after one step the adagrad state of rows "
                                     f"[{w[0]}, {w[1]}) differs by {acc_err.max().item():.3e}")
            worst = max(worst, acc_err.max().item())
        del G_m, dG, err, slack, t0, tol_g
    return worst


def _train_cfg(name: str, mode: str) -> ModelConfig:
    """``name`` at TABLE_SCALE, with bf16 params for a "sparse bf16" path."""
    bf16 = dict(param_dtype="bfloat16") if mode == "sparse bf16" else {}
    return zoo.get_config(name, table_scale=TABLE_SCALE, **bf16)


def _mesh_want(mode: str, dien: bool, D: int, M: int, steps: int) -> dict:
    """A path's launches on a mesh of one card: K1's window D*M a step, K1b's
    window D*M a dense step or K5's window M a sparse step (one a shard, on
    its first copy), K10 once a step (one device), and for dien K3 and K3b
    twice a data slice."""
    return _want(embedding_bag_shard=D * M * steps,
                 embedding_bag_backward_shard=D * M * steps if mode == "dense" else 0,
                 sparse_adagrad_step_shard=M * steps if mode != "dense" else 0,
                 optimizer_update=steps, rnn_scan=2 * D * steps if dien else 0,
                 rnn_scan_backward=2 * D * steps if dien else 0)


def mesh_train_parity(device, name: str, mode: str, D: int, M: int, start: dict, hosts: list,
                      card: str, errs: dict) -> tuple[dict, dict]:
    """One mesh path against the single-device trainer, from the same weights
    (``start``) on the same batches: ``mode`` "dense" (adagrad), "sparse" or
    "dedup" (sparse, ``dedup=True``). Step 1 records the launches of the
    path's kernels and holds each to its plain version (K1's window at the
    call; K1b's or K5's window, and the single-device step's K5, after
    it); holds the mesh's pooled gradients to the single-device ones within
    MESH_G_RTOL of their max |g|; and holds the table and accumulator to
    the single-device step's within the kernels' bounds plus what that
    limit carries (``_sparse_parity``, ``_dense_parity``). The losses of
    MESH_PARITY_STEPS steps agree to TRAIN_LOSS_RTOL; the launches around
    the mesh steps are as ``_mesh_want`` says."""
    cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
    sparse, what = mode != "dense", f"{name} {mode} {D}x{M}"
    kw = dict(optimizer="adagrad", learning_rate=MESH_TRAIN_LR, sparse_tables=sparse,
              dedup=mode == "dedup", params=start)
    single = port_train.Trainer(cfg, device=device, **kw)
    tr = port_train.Trainer(cfg, mesh=_cuda_mesh(device, D, M), **kw)
    labels = [single._labels(h, None) for h in hosts]
    launches = _want()
    if sparse:
        with _recorded(port_train, "sparse_adagrad_step", _k5_pre) as s_calls, \
                _recorded(port_train, "_dedup_stream") as s_ded:
            losses_s = [float(single.step(hosts[0], labels[0]))]
        _merge(errs, "sparse_adagrad_step", _check_k5(s_calls, f"{what}, one device", False))
        s_calls = _without_pre(s_calls)
        _free(device)
        _reset_counts()
        with _recorded(port_train, "sparse_adagrad_step_shard", _k5_pre) as m_calls, \
                _recorded(port_train, "_dedup_stream") as m_ded, \
                _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
            losses_m = [float(tr.step(hosts[0], labels[0]))]
        synchronize(device)
        _add(launches, _counts())
        _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
        _merge(errs, "sparse_adagrad_step_shard", _check_k5(m_calls, what, True))
        m_calls = _without_pre(m_calls)
        # The pooled gradients: the stream K5 takes, or dedup's input.
        s_g = s_ded[0][0][2] if s_ded else s_calls[0][0][4]
        delta = MESH_G_RTOL * s_g.abs().max().item()
        gdiff = max(_check_pooled_grad(c[0][2] if s_ded else c[0][4], s_g, delta, what)
                    for c in (m_ded or m_calls))
        for c in m_ded:  # dedup: K5 takes the merged rows, held to n * delta and rounding
            delta = _dedup_limit(s_ded[0], c, MESH_G_RTOL * s_g.abs().max().item(), what)[0]
        par = _sparse_parity(s_calls[0], m_calls, single, start["tables"], delta, what)
        del s_ded, m_ded
    else:
        with _recorded(emb_mod, "embedding_bag_backward") as s_calls:
            losses_s = [float(single.step(hosts[0], labels[0]))]
        _reset_counts()
        with _recorded(emb_mod, "embedding_bag_backward_shard") as m_calls, \
                _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
            losses_m = [float(tr.step(hosts[0], labels[0]))]
        synchronize(device)
        _add(launches, _counts())
        _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
        _merge(errs, "embedding_bag_backward_shard", _check_k1b_windows(m_calls, what))
        s_g, s_ids = s_calls[0][0][0], s_calls[0][0][2]
        delta = MESH_G_RTOL * s_g.abs().max().item()
        gdiff = _check_slices_grad(s_g, s_ids, m_calls, delta, what)
        rps = tr.params.rows_per_shard
        par = _dense_parity(s_calls[0], m_calls, single.params["tables"],
                            lambda lo: tr.params.entry(0, lo // rps)["tables"],
                            _state_of(single, None),
                            lambda lo: _state_of(tr, tr.params.entry(0, lo // rps)["tables"]),
                            start["tables"], delta, MESH_TRAIN_LR, "adagrad", what)
    del s_calls, m_calls, k1
    _free(device)
    for h, lab in zip(hosts[1:], labels[1:]):
        losses_s.append(float(single.step(h, lab)))
    _reset_counts()
    for h, lab in zip(hosts[1:], labels[1:]):
        losses_m.append(float(tr.step(h, lab)))
    synchronize(device)
    _add(launches, _counts())
    steps = len(hosts)
    want = _mesh_want(mode, cfg.model_type == "dien", D, M, steps)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    rel = float(np.max(np.abs(np.asarray(losses_m) - losses_s) / np.abs(losses_s)))
    if not (np.all(np.isfinite(losses_m)) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"{what}: losses {losses_m} against the single-device trainer's "
                             f"{losses_s} (max relative error {rel:.2e} > {TRAIN_LOSS_RTOL:.0e})")
    _log(f"[17 mesh train] {what} (f32, batch {TRAIN_BATCH}, table_scale {TABLE_SCALE}) on a "
         f"mesh of one card: losses {', '.join(f'{x:.6f}' for x in losses_m)} against the "
         f"single-device trainer's (max relative error {rel:.2e}, limit {TRAIN_LOSS_RTOL:.0e}); "
         f"step 1's K1, {'K5' if sparse else 'K1b'} window launches and the single-device "
         f"step's {'K5' if sparse else 'K1b'} within their plain versions; the pooled gradients "
         f"within {MESH_G_RTOL:.0e} of max |g| of the single-device ones (max |diff| "
         f"{gdiff:.3e}, limit {MESH_G_RTOL * s_g.abs().max().item():.3e}); the table and "
         f"accumulator within the kernels' bounds plus what that limit carries of the "
         f"single-device step's (max |diff| {par:.3e}); launches {_nonzero(launches)} [{card}]")
    del single, tr, s_g
    _free(device)
    return {"losses": losses_m, "rel": rel, "parity": par, "g_diff": gdiff}, launches


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def mesh_train_time(device, name: str, mode: str, axes, card: str,
                    errs: dict | None = None) -> tuple[dict, dict]:
    """A step (host batch to the card, forward, backward, update, the loss
    read back) at full width in two arms from the same weights on the same
    batches (``graph_arms``): the trainer's programs (each step after the
    first a CUDA-graph replay) and its step function called directly,
    eagerly; their agreement, then TRAIN_TIMED steps of each: wall and
    device time a step, idle share, the kernels that took the most device
    time, captures, capture ms, pool bytes and peak device memory (both
    arms' state). ``axes`` None: one device; ``mode`` "make_train_step":
    ``make_train_step``'s SGD step (its programs, and the dense step it
    wraps, called eagerly) in place of trainers'; "sparse bf16": the sparse
    step with bf16 params (K5's bf16 window inside the graph). With
    ``errs`` (a sparse trainer) one more eager step holds its K5 launches to
    the plain version (``_check_k5``), merged into
    ``errs["sparse_adagrad_step"]`` on one device and, on a mesh, into
    ``errs["sparse_adagrad_step_shard"]`` (a bf16 shard's also into
    ``errs["sparse_adagrad_step_shard bf16"]``). Returns the result and the
    graphed arm's launches."""
    cfg = _train_cfg(name, mode)
    _free(device)
    _reset_peak(device)
    mesh = None if axes is None else _cuda_mesh(device, *axes)
    gen = RecDataGenerator(cfg, seed=1)
    hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(GRAPH_STEPS)]
    model = get_model(cfg, device)
    start = model.init(torch.Generator(device=device).manual_seed(0))
    dien = cfg.model_type == "dien"
    where = "one device" if axes is None else f"{axes[0]}x{axes[1]}"
    if mode == "make_train_step":  # SGD through make_train_step
        opt, sparse = "sgd", False
        sps = [shard_params(bridge.tree_map(lambda t: t.clone(), start), mesh) for _ in range(2)]
        runs = [make_train_step(model, mesh, has_dense=cfg.dense_dim > 0,
                                learning_rate=GRAPH_LR[opt], loss="bce",
                                sigmoid_output=sigmoid_output(cfg))(sp) for sp in sps]
        args = [(h, torch.as_tensor(gen.generate_targets(TRAIN_BATCH, round_targets=True)))
                for h in hosts]
        dense_step = runs[1].programs.step  # make_mesh_dense_step's step over sps[1]

        def graphed(h, t):
            return runs[0](sps[0], h, t)[1]

        def eager(h, t):
            return dense_step(h.to(device), t.to(device))

        programs, params, accs = runs[0].programs, (lambda: (sps[0], sps[1])), (lambda: ())
        want = _mesh_want("dense", dien, *axes, GRAPH_STEPS)
    else:
        opt, sparse = "adagrad", mode != "dense"
        trs = [port_train.Trainer(cfg, mesh=mesh, device=device if mesh is None else None,
                                  optimizer=opt, learning_rate=GRAPH_LR[opt],
                                  sparse_tables=sparse, dedup=mode == "dedup", params=start)
               for _ in range(2)]
        tr, ev = trs
        args = [(h, tr._labels(h, None)) for h in hosts]

        def graphed(h, lab):
            return tr.step(h, lab)

        def eager(h, lab):
            return ev._step(ev.params, ev.opt_state, h.to(device), ev._targets(lab))

        programs, params = tr.step_program, (lambda: (tr.params, ev.params))

        def accs():
            return _acc_pairs(tr.opt_state[1], ev.opt_state[1]) if sparse else ()

        want = (_train_want(name, sparse, GRAPH_STEPS) if mesh is None
                else _mesh_want(mode, dien, *axes, GRAPH_STEPS))
    del start
    dtype = "bf16 params" if mode == "sparse bf16" else "f32"
    res, counts = graph_arms(device, f"{name} {mode} on {where}, batch {TRAIN_BATCH} {dtype}",
                             graphed, eager, args, programs, opt, sparse, params, accs, want,
                             TRAIN_TIMED, "17 mesh train", card)
    peak = _peak_gib(device)
    if errs is not None:
        key = "sparse_adagrad_step" if mesh is None else "sparse_adagrad_step_shard"
        with _recorded(port_train, key, _k5_pre) as calls:
            eager(*args[0])
        err = _check_k5(calls, f"{name} {mode} {where}", mesh is not None)
        _merge(errs, key, err)
        if mode == "sparse bf16":
            _merge(errs, f"{key} bf16", err)
        del calls
    _log(f"[17 mesh train] {name} {mode} on {where}: graphed arm's device time by kernel: "
         f"{_top({'us_by_kernel': res['graphed']['by_kernel']}, 6)}; peak of both arms "
         f"{peak:.3f} GiB [{card}]")
    _free(device)
    return {**res, "name": f"{name} {mode} {where}", "peak_gib": peak,
            "k5_window_launches": counts["sparse_adagrad_step_shard"]}, counts


def mesh_dryrun(device, card: str, errs: dict) -> tuple[dict, dict]:
    """``make_train_step`` on the dryrun's tiny "dot" DLRM (DRYRUN_CFG) on a
    2x2 mesh of the card: DRYRUN_STEPS SGD steps on one batch, the loss
    finite and falling, the launches K1's and K1b's windows 4 a step and
    K10 once; step 1's window launches held to their plain versions."""
    cfg = ModelConfig(**DRYRUN_CFG)
    model = get_model(cfg, device)
    mesh = _cuda_mesh(device, 2, 2)
    sp = shard_params(model.init(torch.Generator(device=device).manual_seed(0)), mesh)
    gen = RecDataGenerator(cfg, seed=0)
    host = gen.generate_batch(16).to(device)
    targets = torch.as_tensor(gen.generate_targets(16, round_targets=True)).to(device)
    step = make_train_step(model, mesh, has_dense=True, learning_rate=0.05, loss="bce")(sp)
    what = "dryrun make_train_step 2x2"
    _reset_counts()
    with _recorded(emb_mod, "embedding_bag_backward_shard") as k1b, \
            _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
        losses = [float(step(sp, host, targets)[1])]
    losses += [float(step(sp, host, targets)[1]) for _ in range(DRYRUN_STEPS - 1)]
    counts = _counts()
    _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
    _merge(errs, "embedding_bag_backward_shard", _check_k1b_windows(k1b, what))
    want = _want(embedding_bag_shard=4 * DRYRUN_STEPS, embedding_bag_backward_shard=4 * DRYRUN_STEPS,
                 optimizer_update=DRYRUN_STEPS)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses not finite and falling: {losses}")
    _log(f"[17 mesh train] make_train_step, the dryrun's dot DLRM (d = {cfg.sparse_feature_size}) on 2x2, "
         f"{DRYRUN_STEPS} SGD steps on one batch: losses {', '.join(f'{x:.5f}' for x in losses)}; "
         f"launches {_nonzero(counts)} [{card}]")
    return {"losses": losses}, counts


def mesh_rm1_train_step(device, start: dict, hosts: list, card: str, errs: dict) -> tuple[dict, dict]:
    """rm1's ``make_train_step`` on 2x2 for one SGD step against the
    single-device dense SGD step from the same weights on the same batch:
    the loss to TRAIN_LOSS_RTOL, the pooled gradients to MESH_G_RTOL, the
    table gradient and the table as ``_dense_parity`` holds them, each K1
    and K1b window launch to its plain version."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    single = port_train.Trainer(cfg, device=device, optimizer="sgd", learning_rate=MESH_TRAIN_LR,
                                params=start)
    labels = single._labels(hosts[0], None)
    with _recorded(emb_mod, "embedding_bag_backward") as s_calls:
        loss_s = float(single.step(hosts[0], labels))
    mesh = _cuda_mesh(device, 2, 2)
    sp = shard_params(bridge.tree_map(lambda t: t.clone(), start), mesh)
    step = make_train_step(single.model, mesh, has_dense=True, learning_rate=MESH_TRAIN_LR,
                           loss="bce", sigmoid_output=sigmoid_output(cfg))(sp)
    what = "rm1 make_train_step 2x2"
    _reset_counts()
    with _recorded(emb_mod, "embedding_bag_backward_shard") as m_calls, \
            _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
        loss_m = float(step(sp, hosts[0].to(device), single._targets(labels))[1])
    synchronize(device)
    counts = _counts()
    if counts != _mesh_want("dense", False, 2, 2, 1):
        raise AssertionError(f"{what}: launches {counts}")
    _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
    _merge(errs, "embedding_bag_backward_shard", _check_k1b_windows(m_calls, what))
    s_g, s_ids = s_calls[0][0][0], s_calls[0][0][2]
    delta = MESH_G_RTOL * s_g.abs().max().item()
    gdiff = _check_slices_grad(s_g, s_ids, m_calls, delta, what)
    rps = sp.rows_per_shard
    par = _dense_parity(s_calls[0], m_calls, single.params["tables"],
                        lambda lo: sp.entry(0, lo // rps)["tables"], None, None,
                        start["tables"], delta, MESH_TRAIN_LR, "sgd", what)
    rel = abs(loss_m - loss_s) / abs(loss_s)
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{what}: loss {loss_m} against the single-device {loss_s}")
    _log(f"[17 mesh train] {what}, one SGD step (lr {MESH_TRAIN_LR}) against the single-device "
         f"dense SGD step: loss {loss_m:.6f} / {loss_s:.6f} (relative {rel:.2e}); pooled "
         f"gradients within {MESH_G_RTOL:.0e} of max |g| (max |diff| {gdiff:.3e}, limit "
         f"{delta:.3e}); table within K1b's bounds plus what that limit carries (max |diff| "
         f"{par:.3e}); launches {_nonzero(counts)} [{card}]")
    del s_calls, m_calls, k1, single, sp, step
    _free(device)
    return {"rel": rel, "parity": par}, counts


def k1b_window_cases(device, errs: dict):
    """K1b's window at rm1's training shape (f32, batch TRAIN_BATCH) on its
    aligned shard 1 of MESH_SHARDS and on the same window shifted by half a
    table (three tables meet it, two straddling), masked and not, with the
    meeting tables given (``table_range`` with the fused rows, as the mesh
    path places them) and derived by the wrapper: each against its plain
    version within ``backward_tolerance`` of the window."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    rps = R // MESH_SHARDS
    offsets = table_offsets(cfg, device)
    gen = torch.Generator(device=device).manual_seed(16)
    ids = torch.as_tensor(RecDataGenerator(cfg, seed=14).generate_batch(TRAIN_BATCH).indices,
                          device=device)
    g = torch.randn((TRAIN_BATCH, cfg.num_tables, d), generator=gen, device=device) * 1e-2
    mask = torch.rand(ids.shape, generator=gen, device=device) < 0.7
    for where, lo in (("aligned", rps), ("shifted by half a table", rps + cfg.scaled_rows[0] // 2)):
        w = (lo, lo + rps)
        placed = table_range(cfg.table_offsets, lo, rps, R)
        for tr in (placed, None):
            for m in (None, mask):
                got = embedding_bag_backward_shard(g, offsets, ids, lo, rps, mask=m,
                                                   table_range=tr)
                synchronize(device)
                err = (got - embedding_bag_backward_reference(g, offsets, ids, rps, mask=m,
                                                              window=w)).abs()
                if not bool((err <= backward_tolerance(g, offsets, ids, rps, m, window=w)).all()):
                    raise AssertionError(f"K1b's window disagrees with its plain version (rm1 "
                                         f"rows [{lo}, {lo + rps}), {where})")
                errs["embedding_bag_backward_shard"] = max(errs["embedding_bag_backward_shard"],
                                                           err.max().item())
                del got, err
        _log(f"[17 mesh train] K1b's window ok at rm1's window {where} (rows [{lo}, {lo + rps}), "
             f"tables [{placed.lo}, {placed.hi}), straddling {placed.lo_edge}/{placed.hi_edge}), "
             f"B={TRAIN_BATCH} f32, masked and not, range given and derived: max |err| "
             f"{errs['embedding_bag_backward_shard']:.3e} so far")
    _free(device)


def mesh_window_times(device, card: str) -> dict:
    """K1b's and K5's windows at rm1's training shape on its shard 1 of 4
    (rows [R/4, R/2), f32, batch TRAIN_BATCH, eight batches of ids): each
    beside its plain version (order plain, kernel, kernel, plain), its bound
    and its library yardstick (a windowed ``index_add_`` for K1b;
    ``index_add_`` twice and a gather for K5, on the owned slots' rows
    prepared beforehand). K5's time is the span of its two launches."""
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    rps = R // MESH_SHARDS
    lo = rps
    offsets = table_offsets(cfg, device)
    gen = torch.Generator(device=device).manual_seed(15)
    ids = [b.to(device).indices for b in
           RecDataGenerator(cfg, seed=13).generate_batches(8, TRAIN_BATCH)]
    gs = [torch.randn((TRAIN_BATCH, cfg.num_tables, d), generator=gen, device=device) * 1e-2
          for _ in ids]
    prepared = [window_g_rows(g, offsets, i, lo, rps) for g, i in zip(gs, ids)]
    out = {}
    grad = torch.zeros((rps, d), dtype=torch.float32, device=device)
    runs = _time_runs(
        lambda g, i: embedding_bag_backward_shard(g, offsets, i, lo, rps, out=grad),
        lambda g, i: embedding_bag_backward_reference(g, offsets, i, rps, out=grad,
                                                      window=(lo, lo + rps)),
        k1b_library(grad), list(zip(gs, ids)), [(p[0], p[2]) for p in prepared], TIMED_ITERS)
    out["embedding_bag_backward_shard"] = {**_timed(runs),
                                           **k1b_window_bound(gs[0], offsets, ids[0], lo, rps)}
    del grad
    _free(device)
    shard = (torch.rand((rps, d), generator=gen, device=device) - 0.5) * 0.1
    acc = torch.zeros((rps,), dtype=torch.float32, device=device)

    def k5(g, i):
        sparse_adagrad_step_shard(shard, acc, offsets, i, g, lo, 0.1)

    runs = _time_runs(
        k5, lambda g, i: sparse_adagrad_step_reference(shard, acc, offsets, i, g, 0.1,
                                                       window=(lo, lo + rps)),
        k5_library(shard, acc, 0.1), list(zip(gs, ids)), prepared, TIMED_ITERS)
    t = _timed(runs, "launch_sum_ms")
    out["sparse_adagrad_step_shard"] = {
        **t, **k5_window_bound(shard, gs[0], offsets, ids[0], lo), "launch_sum_ms": t["ms"],
        "ms": span_ms(k5, list(zip(gs, ids)), TIMED_ITERS)}
    for key, label, lib in (("embedding_bag_backward_shard", "K1b's window", "windowed index_add_"),
                            ("sparse_adagrad_step_shard", "K5's window (span of both launches)",
                             "index_add_ x2 + gather")):
        t = out[key]
        _log(f"[17 mesh train times] {label} at rm1's shard 1 of {MESH_SHARDS} (rows "
             f"[{lo}, {lo + rps}), B={TRAIN_BATCH} T=8 L=80 d=32 f32): {_us(t['ms'])} "
             f"({'device' if t['device'] else 'wall'}); bound {_us(t['bound_ms'])} "
             f"({t['bound_by']}, {t['bytes'] / 1e6:.2f} MB); plain {_us(t['plain_ms'])}; {lib} "
             f"{_us(t['library_ms'])}; wall a call {_us(t['k_wall'])}; device time a call by "
             f"kernel: {t['by_kernel']} [{card}]")
    _log(f"[17 mesh train times] K5's window, its two launches' medians summed: "
         f"{_us(out['sparse_adagrad_step_shard']['launch_sum_ms'])} [{card}]")
    del shard, acc
    _free(device)
    out["sparse_adagrad_step_shard bf16"] = k5_bf16_window_graphed(
        device, offsets, list(zip(gs, ids)), prepared, lo, rps, d, card)
    del prepared
    _free(device)
    return out


def k5_bf16_window_graphed(device, offsets, args: list, prepared: list, lo: int, rps: int,
                           d: int, card: str) -> dict:
    """K5's window on a bf16 shard (rm1's shard 1 of 4, f32 gradients) as
    the graphed steps run it: captured once (``serving.programs.capture``:
    the call's own scratch in the graph's pool, its count and keys set by
    memsets inside the graph) over static ids and gradients, then, for each
    of ``args``' batches copied into them, a replay held to the plain
    version within ``sparse_adagrad_tolerance``. Timed: the replay's
    span (``span_ms``), the eager call's span, each launch's median summed,
    the plain version (plain, kernel, kernel, plain), ``k5w_library_bf16``
    on the owned slots' rows prepared beforehand, and the bound. Returns
    the times, the bound and the max |err|."""
    from deeprecsys_tpu_torch.kernel_bench import k5w_library_bf16
    from deeprecsys_tpu_torch.serving.programs import capture

    gen = torch.Generator(device=device).manual_seed(16)
    shard = ((torch.rand((rps, d), generator=gen, device=device) - 0.5) * 0.1).to(torch.bfloat16)
    acc = torch.zeros((rps,), dtype=torch.float32, device=device)
    g_in, ids_in = args[0][0].clone(), args[0][1].clone()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        sparse_adagrad_step_shard(shard, acc, offsets, ids_in, g_in, lo, 0.1)  # builds, warms
        graph, _, tally, _ = capture(
            lambda: sparse_adagrad_step_shard(shard, acc, offsets, ids_in, g_in, lo, 0.1),
            torch.cuda.graph_pool_handle(), stream)
    stream.synchronize()
    worst = 0.0
    for g, i in args:
        g_in.copy_(g)
        ids_in.copy_(i)
        t0, a0 = shard.clone(), acc.clone()
        torch.cuda.synchronize(device)
        graph.replay()  # on the current stream, after the copies
        torch.cuda.synchronize(device)
        want_t, want_a = _k5_ref(t0, a0, offsets, i, g, 0.1, 1e-8, (lo, lo + rps))
        tol, acc_tol = sparse_adagrad_tolerance(t0, a0, offsets, i, g, 0.1, window=(lo, lo + rps))
        err, acc_err = (shard.float() - want_t.float()).abs(), (acc - want_a).abs()
        if not (bool((err <= tol).all()) and bool((acc_err <= acc_tol).all())):
            raise AssertionError(f"K5's bf16 window replayed in a graph disagrees with its plain "
                                 f"version: max |err| table {err.max().item():.3e}, acc "
                                 f"{acc_err.max().item():.3e}")
        worst = max(worst, err.max().item(), acc_err.max().item())
        del t0, a0, want_t, want_a, tol, acc_tol, err, acc_err
    if tally != {sparse_adagrad_step_shard: 1}:
        raise AssertionError(f"K5's bf16 window's capture recorded {tally}")

    def k5(g, i):
        sparse_adagrad_step_shard(shard, acc, offsets, i, g, lo, 0.1)

    runs = _time_runs(
        k5, lambda g, i: sparse_adagrad_step_reference(shard, acc, offsets, i, g, 0.1,
                                                       window=(lo, lo + rps)),
        k5w_library_bf16(shard, acc, 0.1), args,
        [(*pr, *torch.unique(pr[2], return_inverse=True)) for pr in prepared], TIMED_ITERS)
    t = _timed(runs, "launch_sum_ms")
    out = {**t, **k5_window_bound(shard, args[0][0], offsets, args[0][1], lo),
           "launch_sum_ms": t["ms"], "eager_ms": span_ms(k5, args, TIMED_ITERS),
           "ms": span_ms(lambda g, i: graph.replay(), args, TIMED_ITERS), "max_abs_err": worst}
    _log(f"[17 mesh train times] K5's window on a bf16 shard, rm1's shard 1 of {MESH_SHARDS} "
         f"(B={TRAIN_BATCH} T=8 L=80 d={d}, f32 g), replayed in a CUDA graph over "
         f"{len(args)} batches: max |err| against the plain version {worst:.3e} (within "
         f"sparse_adagrad_tolerance); replay span "
         f"{_us(out['ms'])}, eager span {_us(out['eager_ms'])}, launches' medians summed "
         f"{_us(out['launch_sum_ms'])}; bound {_us(out['bound_ms'])} ({out['bound_by']}); plain "
         f"{_us(out['plain_ms'])}; k5w_library_bf16 {_us(out['library_ms'])} [{card}]")
    del graph, shard, acc
    return out


def dedup_times(device, card: str, errs: dict) -> tuple[dict, dict]:
    """The measurement ROADMAP Queue 2 item 5 asks for: single-device sparse
    steps of rm1 and rm2 with ``dedup=True`` against ``False``
    (``mesh_train_time``, each step's K5 then held to its plain version:
    dedup's K5 takes the unique rows as bags of one), and
    ``dedup_touched_rows`` alone (the sort and the segment sum) at the
    step's stream (batch TRAIN_BATCH's B*T*L rows). Returns the results
    and the graphed arms' launches."""
    out, launches = {}, _want()
    for name in DEDUP_MODELS:
        steps = {}
        for mode in ("sparse", "dedup"):
            steps[mode], counts = mesh_train_time(device, name, mode, None, card, errs)
            _add(launches, counts)
        cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
        offsets = table_offsets(cfg, device)
        ids = torch.as_tensor(RecDataGenerator(cfg, seed=1).generate_batch(TRAIN_BATCH).indices,
                              device=device)
        B, T, L = ids.shape
        d = cfg.sparse_feature_size
        g = torch.randn((B, T, d), device=device)
        flat = (ids + offsets[None, :, None]).reshape(-1)
        rows = g[:, :, None, :].expand(B, T, L, d).reshape(-1, d)
        m = measure(lambda: port_train.dedup_touched_rows(flat, rows), [()], TIMED_ITERS)
        out[name] = {**steps, "sort_segment_ms": m["device_ms"], "sort_segment_wall_ms": m["wall_ms"]}
        s, dd = steps["sparse"]["graphed"], steps["dedup"]["graphed"]
        _log(f"[17 dedup] {name} single-device sparse step, batch {TRAIN_BATCH} f32 "
             f"({B * T * L} touched slots): dedup=False wall {s['wall_ms']:.4f} ms, device "
             f"{_us(s['device_ms'])}; dedup=True wall {dd['wall_ms']:.4f} ms, device "
             f"{_us(dd['device_ms'])}; dedup_touched_rows alone (sort + segment sum) device "
             f"{_us(m['device_ms'])}, wall {_us(m['wall_ms'])} [{card}]")
        del flat, rows, g, ids
        _free(device)
    return out, launches


def _sync_cards(cards: list):
    for c in cards:
        torch.cuda.synchronize(c)


def _measure_cards(fn, args: list, iters: int, cards: list) -> dict:
    """A step's wall (host clock over ``iters`` back-to-back calls cycling
    through ``args``, after a warm-up call each, every card synchronised on
    either side) and its device time by card (the summed kernel and copy
    durations on each card, from a torch.profiler trace of a second loop,
    traced again up to three times when a trace shows no device activity);
    each card's idle share ``1 - device / wall``. On the CPU the wall
    alone."""
    for a in args:
        fn(*a)
    on_card = cards[0].type == "cuda"
    if on_card:
        _sync_cards(cards)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args[i % len(args)])
    if on_card:
        _sync_cards(cards)
    wall = (time.perf_counter() - t0) * 1e3 / iters
    by_card: dict = {}
    for _ in range(3 if on_card else 0):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            for i in range(iters):
                fn(*args[i % len(args)])
            _sync_cards(cards)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_card[e.device_index] = (by_card.get(e.device_index, 0.0)
                                           + e.time_range.elapsed_us() / 1e3 / iters)
        if by_card:
            break
    idle = {c: 1 - ms / wall for c, ms in sorted(by_card.items())}
    return {"wall_ms": wall, "device_ms_by_card": dict(sorted(by_card.items())),
            "device_ms": sum(by_card.values()) if by_card else None, "idle_by_card": idle,
            "idle": float(np.mean(list(idle.values()))) if idle else None}


def _cards_text(a: dict) -> str:
    if a["device_ms"] is None:
        return f"wall {a['wall_ms']:.4f} ms a step, device not measured"
    dev = ", ".join(f"cuda:{c} {ms:.4f}" for c, ms in a["device_ms_by_card"].items())
    idle = ", ".join(f"{100 * x:.1f}%" for x in a["idle_by_card"].values())
    return (f"wall {a['wall_ms']:.4f} ms a step, device ms by card {dev}, idle by card {idle} "
            f"(mean {100 * a['idle']:.1f}%)")


def _card_tally(prog, wrapper: str | None = None) -> dict:
    """A staged program's launches a replay by card index (``wrapper``: that
    kernel's alone), from its parts' capture tallies."""
    out: dict = {}
    for dev, tally in prog.stage_launches:
        n = sum(v for w, v in tally.items() if wrapper is None or w.__name__ == wrapper)
        out[dev.index] = out.get(dev.index, 0) + n
    return {c: n for c, n in sorted(out.items()) if n}


def mesh_train_cards_path(device, cards: list, name: str, mode: str, D: int, M: int,
                          card: str) -> tuple[dict, dict]:
    """One path over a D x M mesh of distinct cards (``MESH_TRAIN_CARDS``),
    rm1 or dien at full width, f32, batch TRAIN_BATCH: ``mode`` "dense"
    (adagrad), "sparse", "dedup" (sparse, ``dedup=True``) or
    "make_train_step" (its SGD step), in three arms from the same weights on
    the same batches: graphed over the cards (the trainer's programs: each
    step after the first a replay of a graph a part of the step on its
    card), eager over the cards (the step function called directly), and
    graphed on card 0's virtual shards of the same mesh. The graphed and
    eager arms agree over GRAPH_STEPS steps within the GRAPH_* limits, make
    the launches ``_cards_want`` says, and the same launches by card (the
    graphed arm's parts' tallies, its eager first step's and the eager arm's
    launches from Python); no kernel wrapper is called from Python over the
    replays; K1b's window launches once a (d, m) on that entry's card
    (dense), K5's window once a shard on its entry (0, m)'s card (sparse).
    The one-card arm's losses agree with the graphed arm's within
    GRAPH_LOSS_RTOL. Then each arm's step is timed over TRAIN_TIMED steps
    (``_measure_cards``). "sparse bf16": the sparse step with bf16 params
    (K5's bf16 window inside its card's graph), the one-card arm's losses
    within GRAPH_BF16_LOSS_RTOL. Returns the result and the graphed arm's
    launches."""
    cfg = _train_cfg(name, mode)
    over = cards[:D * M]
    for c in over:
        _reset_peak(c)
    meshes = (make_mesh(D, M, devices=over), make_mesh(D, M, devices=over),
              _cuda_mesh(device, D, M))
    gen = RecDataGenerator(cfg, seed=1)
    hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(GRAPH_STEPS)]
    model = get_model(cfg, device)
    start = model.init(torch.Generator(device=device).manual_seed(0))
    what = f"{name} {mode} {D}x{M} over {D * M} cards"
    if mode == "make_train_step":
        opt, sparse = "sgd", False
        sps = [shard_params(bridge.tree_map(lambda t: t.clone(), start), mesh) for mesh in meshes]
        steps = [make_train_step(model, mesh, has_dense=cfg.dense_dim > 0,
                                 learning_rate=GRAPH_LR[opt], loss="bce",
                                 sigmoid_output=sigmoid_output(cfg))(sp)
                 for sp, mesh in zip(sps, meshes)]
        args = [(h, torch.as_tensor(gen.generate_targets(TRAIN_BATCH, round_targets=True)))
                for h in hosts]
        arms = {"graphed": lambda h, t: steps[0](sps[0], h, t)[1],
                "eager": lambda h, t: steps[1].programs.step(h.to(device), t.to(device)),
                "one card": lambda h, t: steps[2](sps[2], h, t)[1]}
        programs = {"graphed": steps[0].programs, "one card": steps[2].programs}
        params, accs = (lambda: (sps[0], sps[1])), (lambda: ())
    else:
        opt, sparse = "adagrad", mode != "dense"
        trs = [port_train.Trainer(cfg, mesh=mesh, optimizer=opt, learning_rate=GRAPH_LR[opt],
                                  sparse_tables=sparse, dedup=mode == "dedup", params=start)
               for mesh in meshes]
        args = [(h, trs[0]._labels(h, None)) for h in hosts]
        ev = trs[1]
        arms = {"graphed": lambda h, lab: trs[0].step(h, lab),
                "eager": lambda h, lab: ev._step(ev.params, ev.opt_state, h.to(device),
                                                 ev._targets(lab)),
                "one card": lambda h, lab: trs[2].step(h, lab)}
        programs = {"graphed": trs[0].step_program, "one card": trs[2].step_program}
        params = lambda: (trs[0].params, ev.params)  # noqa: E731

        def accs():
            return _acc_pairs(trs[0].opt_state[1], ev.opt_state[1]) if sparse else ()
    del start
    if programs["graphed"].cut is None or programs["one card"].cut is not None:
        raise AssertionError(f"{what}: the graphed arm is not cut into parts by card, or the "
                             f"one-card arm is")
    dien = cfg.model_type == "dien"
    want = _mesh_want("dense" if mode == "make_train_step" else mode, dien, D, M, GRAPH_STEPS)
    want["optimizer_update"] = len(set(over)) * GRAPH_STEPS  # K10 once a card a step
    _reset_counts()
    with _PythonLaunches() as py:
        losses_g = [float(arms["graphed"](*args[0]))]
        first, first_by = py.n, dict(py.by_card)
        losses_g += [float(arms["graphed"](*a)) for a in args[1:]]
    _sync_cards(over)
    counts_g = _counts()
    _reset_counts()
    with _PythonLaunches() as pe:
        losses_e = [float(arms["eager"](*a)) for a in args]
    _sync_cards(over)
    counts_e = _counts()
    if counts_g != want or counts_e != want:
        raise AssertionError(f"{what}: launches graphed {_nonzero(counts_g)}, eager "
                             f"{_nonzero(counts_e)}, expected {_nonzero(want)}")
    progs = programs["graphed"]
    (prog,) = progs.programs.values()
    on_card = device.type == "cuda"
    if (py.n != first or progs.captures != on_card
            or len(prog.graphs) != (len(prog.stages) if on_card else 0)):
        raise AssertionError(f"{what}: {py.n - first} launches from Python over the replays, "
                             f"{progs.captures} captures, {len(prog.graphs)} graphs for "
                             f"{len(prog.stages)} parts")
    tally = _card_tally(prog)
    eager_by = {c: n / GRAPH_STEPS for c, n in sorted(pe.by_card.items())}
    # The graphed arm's first call runs the step's parts eagerly, then captures them.
    if tally != eager_by or dict(sorted(first_by.items())) != {c: 2 * n for c, n in tally.items()}:
        raise AssertionError(f"{what}: launches a step by card: graphed {tally} (its first "
                             f"call, the eager parts and their capture: {first_by}), eager "
                             f"{eager_by}")
    entries = {}
    for d in range(D):
        for m in range(M):
            c = over[d * M + m].index
            entries[c] = entries.get(c, 0) + 1
    if mode in ("dense", "make_train_step"):
        k1b = _card_tally(prog, "embedding_bag_backward_shard")
        if k1b != entries:
            raise AssertionError(f"{what}: K1b window launches by card {k1b}, entries {entries}")
        per = f"K1b's window by card {k1b}"
    else:
        k5, shards = _card_tally(prog, "sparse_adagrad_step_shard"), {}
        for m in range(M):
            shards[over[m].index] = shards.get(over[m].index, 0) + 1
        if k5 != shards:
            raise AssertionError(f"{what}: K5 window launches by card {k5}, first copies "
                                 f"{shards}")
        per = f"K5's window by card {k5}"
    agree = check_graph_agreement(what, losses_g, losses_e, *params(), opt, sparse,
                                  GRAPH_STEPS, accs())
    losses_v = [float(arms["one card"](*a)) for a in args]
    rel_v = float(np.max(np.abs(np.asarray(losses_v) - losses_g) / np.abs(losses_g)))
    if not rel_v <= agree["loss_rtol"]:
        raise AssertionError(f"{what}: one card's losses {losses_v} against the graphed "
                             f"arm's {losses_g} (max relative error {rel_v:.2e})")
    times = {arm: _measure_cards(fn, args, TRAIN_TIMED, over if arm != "one card" else [device])
             for arm, fn in arms.items()}
    pools = {arm: {f"cuda:{i}": b / 2**20 for i, b in sorted(p.pool_bytes_by_card().items())}
             for arm, p in programs.items()}
    peak = max(_peak_gib(c) for c in over)
    parts = len(prog.stages)
    dtype = "bf16 params" if mode == "sparse bf16" else "f32"
    _log(f"[17 mesh train cards] {what} ({dtype}, batch {TRAIN_BATCH}): graphed and eager arms "
         f"agree over {GRAPH_STEPS} steps (losses max relative {agree['loss_rel']:.2e}, limit "
         f"{agree['loss_rtol']:.0e}; params {agree['param_share']:.3f} of their limits, max |diff| "
         f"{agree['param_max_diff']:.3e}); one card's virtual shards' losses max relative "
         f"{rel_v:.2e}; launches a step by card {tally} in both arms, none from Python over the "
         f"replays; {per} [{card}]")
    for arm in ("graphed", "eager", "one card"):
        extra = ""
        if arm in programs:
            p = programs[arm]
            (pp,) = p.programs.values()
            n = len(pp.stages) if hasattr(pp, "stages") else 1
            extra = (f"; {p.captures} captures, {n} part(s), {p.capture_ms / n:.2f} ms a part "
                     f"(in all {p.capture_ms:.1f}); graph pool MiB by card "
                     f"{ {k: round(v, 1) for k, v in pools[arm].items()} }")
        _log(f"[17 mesh train cards] {what}, {arm}: {_cards_text(times[arm])}{extra} [{card}]")
    _log(f"[17 mesh train cards] {what}: graphed {times['graphed']['wall_ms']:.4f} ms, eager "
         f"{times['eager']['wall_ms']:.4f}, one card {times['one card']['wall_ms']:.4f} a step "
         f"(eager / graphed {times['eager']['wall_ms'] / times['graphed']['wall_ms']:.2f}x, "
         f"graphed / one card {times['graphed']['wall_ms'] / times['one card']['wall_ms']:.2f}x); "
         f"{parts} parts; peak over the cards {peak:.3f} GiB [{card}]")
    return {"name": what, "times": times, **agree, "one_card_rel": rel_v, "parts": parts,
            "launches_by_card": tally, "capture_ms": progs.capture_ms, "pool_mib": pools,
            "peak_gib": peak, "k5_window_launches": counts_g["sparse_adagrad_step_shard"]}, counts_g


def mesh_train_cards(device, card: str) -> tuple[dict, dict]:
    """Phase 17's part over several cards: each path of ``MESH_TRAIN_CARDS``
    whose mesh the machine's cards hold (``mesh_train_cards_path``). With
    one card, a line says that this part did not run. Returns the results
    and the graphed arms' launches."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 2:
        _log(f"[17 mesh train cards] training over several cards needs two cards or more; this "
             f"machine has {n}: not run [{card}]")
        return {}, _want()
    cards = [torch.device("cuda", i) for i in range(n)]
    out, launches = {}, _want()
    for name, mode, (D, M) in MESH_TRAIN_CARDS:
        if D * M > n:
            continue
        res, counts = mesh_train_cards_path(device, cards, name, mode, D, M, card)
        out[res["name"]] = res
        _add(launches, counts)
        _free(device)
    return out, launches


def phase_mesh_train(device, card: str) -> tuple[dict, dict]:
    """Phase 17: training over meshes whose entries all name the card
    (virtual shards: every launch, gradient reduction and update runs; no
    scaling across cards is shown). rm1 at full size (f32, batch
    TRAIN_BATCH): dense adagrad on 1x4 and 2x2, sparse on 1x4, 2x2 and 4x1,
    a 2x2 dedup step against the single-device dedup step, dien sparse on
    1x4 (a model axis that divides its rows), each against the
    single-device trainer (``mesh_train_parity``); ``make_train_step`` on
    the dryrun's DLRM and, for rm1, one step against the single-device SGD
    step; then the windows' times, each path's step times and the dedup
    measurement. Returns the results (``errs``: each checked kernel's max
    |err| against its plain version) and the launches of the paths."""
    t0 = time.perf_counter()
    errs = {"embedding_bag_shard": 0.0, "embedding_bag_backward_shard": 0.0,
            "sparse_adagrad_step_shard": 0.0, "sparse_adagrad_step": 0.0}
    launches = _want()
    out = {"parity": {}, "steps": []}
    for name, runs in (("rm1", MESH_TRAIN_RUNS), ("dien", (("sparse", 1, 4),))):
        cfg = zoo.get_config(name, table_scale=TABLE_SCALE)
        start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
        gen = RecDataGenerator(cfg, seed=1)
        hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(MESH_PARITY_STEPS)]
        for mode, D, M in runs:
            res, counts = mesh_train_parity(device, name, mode, D, M, start, hosts, card, errs)
            out["parity"][f"{name} {mode} {D}x{M}"] = res
            _add(launches, counts)
        if name == "rm1":
            res, counts = mesh_rm1_train_step(device, start, hosts, card, errs)
            out["parity"]["rm1 make_train_step 2x2"] = res
            _add(launches, counts)
        del start
        _free(device)
    out["dryrun"], counts = mesh_dryrun(device, card, errs)
    _add(launches, counts)
    k1b_window_cases(device, errs)
    out["times"] = mesh_window_times(device, card)
    for name, mode, axes in MESH_TIMED_RUNS:
        res, counts = mesh_train_time(device, name, mode, axes, card,
                                      errs if mode == "sparse bf16" else None)
        out["steps"].append(res)
        _add(launches, counts)
    out["dedup"], counts = dedup_times(device, card, errs)
    _add(launches, counts)
    out["cards"], counts = mesh_train_cards(device, card)
    _add(launches, counts)
    out["bf16_launches"] = sum(r["k5_window_launches"] for r in
                               [*out["steps"], *out["cards"].values()] if "bf16" in r["name"])
    out["errs"] = errs
    _log(f"[17 mesh train] phase 17 in {time.perf_counter() - t0:.1f} s")
    return out, launches


@contextlib.contextmanager
def _collectives():
    """The collective calls of ``torch.distributed`` this process makes
    inside the block, counted (one count for all kinds)."""
    import torch.distributed as dist

    names = ("all_reduce", "broadcast", "all_gather_object")
    calls, origs = [0], {n: getattr(dist, n) for n in names}

    def counted(fn):
        def call(*args, **kwargs):
            calls[0] += 1
            return fn(*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counted(origs[n]))
    try:
        yield calls
    finally:
        for n, fn in origs.items():
            setattr(dist, n, fn)


def _dist_mesh(device, D: int, M: int):
    """A D x M mesh over every process of the group: this process's share of
    the entries, each ``device``."""
    return make_mesh(D, M, devices=[device] * (D * M // DIST_PROCS))


def _dist_train(device, cfg, mode: str, start: dict, hosts: list, errs: dict) -> tuple:
    """``mode`` ("dense" or "sparse") adagrad on DIST_TRAIN_AXES across the
    processes from ``start`` on ``hosts``: every step's K1 window launches
    held to their plain version at the call, its K1b or K5 window launches
    after the step, before the next; the launches of the DIST_STEPS steps
    (this process's: 2 a step of each window on 1x4, K10 once); then
    DIST_TIMED steps timed by CUDA events. Returns ``(losses, step wall ms,
    collectives a step, launches)``."""
    D, M = DIST_TRAIN_AXES
    sparse, what = mode == "sparse", f"rm1 {mode} {D}x{M} across {DIST_PROCS} processes"
    tr = port_train.Trainer(cfg, mesh=_dist_mesh(device, D, M), optimizer="adagrad",
                            learning_rate=MESH_TRAIN_LR, sparse_tables=sparse, params=start)
    labels = [tr._labels(h, None) for h in hosts]
    _reset_counts()
    window = ((port_train, "sparse_adagrad_step_shard", _k5_pre) if sparse
              else (emb_mod, "embedding_bag_backward_shard", None))
    losses = []
    for h, lab in zip(hosts, labels):
        with _recorded(*window) as calls, \
                _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
            losses.append(float(tr.step(h, lab)))
        synchronize(device)
        _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
        if sparse:  # before the next step changes the shards the calls hold
            _merge(errs, "sparse_adagrad_step_shard", _check_k5(calls, what, True))
        else:
            _merge(errs, "embedding_bag_backward_shard", _check_k1b_windows(calls, what))
        del calls, k1
    counts = _counts()
    local = D * M // DIST_PROCS
    _mesh_launch_check(counts, _want(
        embedding_bag_shard=local * len(hosts),
        embedding_bag_backward_shard=0 if sparse else local * len(hosts),
        sparse_adagrad_step_shard=local * len(hosts) if sparse else 0,
        optimizer_update=len(hosts)), what)
    with _collectives() as calls:
        wall = wall_ms(lambda h, lab: tr.step(h, lab), list(zip(hosts, labels)), DIST_TIMED)
    del tr
    _free(device)
    return losses, wall, calls[0] / DIST_TIMED, counts


def _direct_err(quant: str, what: str):
    """An ``after`` for the direct kernel of ``quant``'s layout
    (``LOOKUP[quant]``) on a table-wise shard: its pooled output against its
    plain version on the same shard, offsets and ids (K1-int8 bit for bit,
    K1 and K4 within their tolerances). Returns the max |err|."""
    def check(args, kw, out):
        cdt, mask = kw.get("compute_dtype"), kw.get("mask")
        if quant == "int8":
            tbl, scale, offs, idx = args[:4]
            want = embedding_bag_int8_reference(tbl, scale, offs, idx, compute_dtype=cdt,
                                                mask=mask)
            if not torch.equal(out, want):
                raise AssertionError(f"K1-int8 differs from its plain version ({what})")
            return 0.0
        tbl, offs, idx = args[:3]
        plain = embedding_bag_reference if quant == "none" else embedding_bag_int8_rowwise_reference
        return _check_pooled(out, plain(tbl, offs, idx, compute_dtype=cdt, mask=mask), tbl, offs,
                             idx, mask, what, kernel=LOOKUP[quant],
                             tolerance=pooled_tolerance if quant == "none" else rowwise_tolerance)

    return check


def _k6_shard_err(quant: str, what: str):
    """An ``after`` for K6's shard mode of ``quant``'s layout
    (``HOTCOLD_SHARD[quant]``): the partial against its plain version on the
    same shard and split (the cold-only route's where ``hot`` is None), as
    ``_check_partial`` holds it. Returns the max |err|."""
    def check(args, kw, out):
        hot, shard, split = args[:3]
        want = _hotcold_partial(quant, hot, shard, split, plain=True)
        return _check_partial(quant, out, want, shard,
                              f"{what}: C_pad {split['cold_ids'].numel()}"
                              + (", cold-only" if hot is None else ""),
                              _hotcold_tol(quant, hot, split))

    return check


def _dist_layouts(device, cfg, errs: dict, launches: dict) -> dict:
    """rm1 (``cfg``, bf16) in each table layout on DIST_LAYOUT_PATHS across
    the processes, at BATCH on phase 16's zipf(1.2) stream with the JAX
    hot-set rule: one forward of each path held to the single-device direct
    forward (bf16_atol), every launch of the path's kernel in it (K1,
    K1-int8 or K4 on a table-wise shard; K6's shard mode on a hot/cold
    cell, shard 0 with the hits, the others cold-only) held to its plain
    version at the call, its launches checked against this process's cells;
    the kernel of each route (a table-wise cell; K6 with the hits, K6
    cold-only) timed at its first cell's shapes in this child
    (``measure``'s launch sum: while the other child runs too); then
    DIST_TIMED forwards timed by CUDA events (the hot/cold host split
    inside, as a caller runs it). Returns ``{"<path> <layout> DxM":
    results}``."""
    zipf = zipf_stream(cfg, BATCH, seed=31)
    dense = np.random.default_rng(31).random((BATCH, cfg.dense_dim), dtype=np.float32)
    host = Batch(dense=dense, indices=zipf)
    batch = host.to(device)
    tail = Batch(dense=batch.dense, indices=None)
    hot_ids, _ = _hot_set(cfg, zipf)
    out = {}
    for quant in ("none",) + QUANT_MODES:
        qcfg = cfg.replace(table_quant=quant)
        model = get_model(qcfg, device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        want = model.apply(params, batch).float().cpu().numpy()
        for path, D, M in DIST_LAYOUT_PATHS:
            mesh = _dist_mesh(device, D, M)
            if path == "table-wise":
                tw = make_tablewise_model(model, mesh)
                tw_params = tw.convert_params(params)
                kernel, after = LOOKUP[quant], _direct_err
                fn, args = tw.apply, (tw_params, batch)
            else:
                hc = make_hotcold_model(model, hot_ids, mesh=mesh)
                hp = shard_params(hc.convert_params(params), mesh)
                kernel, after = HOTCOLD_SHARD[quant], _k6_shard_err
                fn, args = (lambda hc, hp: hc.apply(hp, tail, hc.prepare(host))), (hc, hp)
            key = f"{path} {quant} {D}x{M}"
            what = f"rm1 bf16 {key} across {DIST_PROCS} processes"
            _reset_counts()
            with _recorded(port_ops, kernel, after=after(quant, what)) as calls:
                got = fn(*args)
            synchronize(device)
            counts = _counts()
            _mesh_launch_check(counts, _want(**{kernel: D * M // DIST_PROCS}), what)
            _add(launches, counts)
            _merge(errs, kernel, _worst(calls, what, kernel))
            worst = _check_close(got.float().cpu().numpy(), want, what)
            kernel_ms = {}
            for c_args, c_kw, _, _ in calls:
                route = ("cell" if path == "table-wise"
                         else "cold-only" if c_args[0] is None else "shard 0")
                if route not in kernel_ms:
                    wrapper = getattr(port_ops, kernel)
                    kernel_ms[route] = measure(lambda: wrapper(*c_args, **c_kw), [()],
                                               DIST_KERNEL_ITERS)["launch_sum_ms"]
            with _collectives() as coll:
                wall = wall_ms(fn, [args], DIST_TIMED)
            out[key] = {"max_abs_err": worst, "wall_ms": wall, "kernel_ms": kernel_ms,
                        "collectives": coll[0] / DIST_TIMED}
            del args, fn, calls, got
        del params, model, tw, tw_params, hc, hp
        _free(device)
    return out


def dist_child(rank: int, port: int, device_name: str, table_scale: int, q):
    """One of DIST_PROCS processes of phase 18 (spawned): joins the group,
    runs rm1's forward (float, per-table int8, row-wise int8) and steps on
    meshes across the processes, holds every launch of K1's, K1-int8's,
    K4's, K1b's and K5's windows to its plain version, and puts ``(rank,
    "ok", results)`` (or ``"error"`` with the traceback)."""
    import torch.distributed as dist

    try:
        device = torch.device(device_name)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # NCCL refuses two ranks on one card: processes that share it name gloo.
        distributed_init(f"127.0.0.1:{port}", num_processes=DIST_PROCS, process_id=rank,
                         backend="gloo")
        errs = {"embedding_bag_shard": 0.0, "embedding_bag_backward_shard": 0.0,
                "sparse_adagrad_step_shard": 0.0, **{SHARD[q]: 0.0 for q in QUANT_MODES},
                **{k: 0.0 for k in (*LOOKUP.values(), *HOTCOLD_SHARD.values())}}
        launches, out = _want(), {"fwd": {}, "train": {}}
        cfg = zoo.get_config("rm1", table_scale=table_scale, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
        model = get_model(cfg, device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        batches = [b.to(device) for b in
                   RecDataGenerator(cfg, seed=1).generate_batches(DIST_FWD_BATCHES, BATCH)]
        with torch.inference_mode():
            wants = [model.apply(params, b).float().cpu().numpy() for b in batches]
            for D, M in DIST_FWD_AXES:
                what = f"rm1 bf16 sharded_apply {D}x{M} across {DIST_PROCS} processes"
                mesh = _dist_mesh(device, D, M)
                sp = shard_params(params, mesh)
                fn = sharded_apply(model, mesh, has_dense=True)
                _reset_counts()
                with _recorded(port_ops, "embedding_bag_shard", after=_k1_window_err(what)) as k1:
                    outs = [fn(sp, b) for b in batches]
                synchronize(device)
                counts = _counts()
                _mesh_launch_check(counts, _want(
                    embedding_bag_shard=len(batches) * D * M // DIST_PROCS), what)
                _add(launches, counts)
                _merge(errs, "embedding_bag_shard", max(c[3] for c in k1))
                worst = max(_check_close(o.float().cpu().numpy(), w, what)
                            for o, w in zip(outs, wants))
                with _collectives() as calls:
                    wall = wall_ms(fn, [(sp, b) for b in batches], DIST_TIMED)
                out["fwd"][f"float {D}x{M}"] = {"max_abs_err": worst, "wall_ms": wall,
                                                "collectives": calls[0] / DIST_TIMED}
                del sp, fn, outs, k1
            del params, wants
            _free(device)
            D, M = DIST_QUANT_AXES
            for quant in QUANT_MODES:
                what = f"rm1 {quant} sharded_apply {D}x{M} across {DIST_PROCS} processes"
                qcfg = cfg.replace(table_quant=quant)
                qmodel = get_model(qcfg, device)
                qparams = qmodel.init(torch.Generator(device=device).manual_seed(0))
                wants = [qmodel.apply(qparams, b).float().cpu().numpy() for b in batches]
                mesh = _dist_mesh(device, D, M)
                sp = shard_params(qparams, mesh)
                fn = sharded_apply(qmodel, mesh, has_dense=True)
                _reset_counts()
                with _recorded(port_ops, SHARD[quant], after=_int8_window_err(quant, what)) as w8:
                    outs = [fn(sp, b) for b in batches]
                synchronize(device)
                counts = _counts()
                _mesh_launch_check(counts, _want(
                    **{SHARD[quant]: len(batches) * D * M // DIST_PROCS}), what)
                _add(launches, counts)
                _merge(errs, SHARD[quant], max(c[3] for c in w8))
                worst = max(_check_close(o.float().cpu().numpy(), w, what)
                            for o, w in zip(outs, wants))
                with _collectives() as calls:
                    wall = wall_ms(fn, [(sp, b) for b in batches], DIST_TIMED)
                out["fwd"][f"{quant} {D}x{M}"] = {"max_abs_err": worst, "wall_ms": wall,
                                                  "collectives": calls[0] / DIST_TIMED}
                del qparams, wants, sp, fn, outs, w8
                _free(device)
            del batches
            _free(device)
            out["paths"] = _dist_layouts(device, cfg, errs, launches)
        cfg = zoo.get_config("rm1", table_scale=table_scale)
        start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
        gen = RecDataGenerator(cfg, seed=1)
        hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(DIST_STEPS)]
        for mode in ("dense", "sparse"):
            losses, wall, calls, counts = _dist_train(device, cfg, mode, start, hosts, errs)
            out["train"][mode] = {"losses": losses, "wall_ms": wall, "collectives": calls}
            _add(launches, counts)
        out["errs"], out["launches"] = errs, launches
        q.put((rank, "ok", out))
    except Exception:  # the parent raises it
        q.put((rank, "error", traceback.format_exc()[-4000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_dist(device, card: str) -> tuple[dict, dict]:
    """Phase 18: a mesh across processes. DIST_PROCS spawned processes share
    the card over gloo (NCCL refuses two ranks on one card), each with half
    of the entries: rm1 at full size through ``sharded_apply`` in bf16 on
    DIST_FWD_AXES, and with per-table and row-wise int8 tables on
    DIST_QUANT_AXES, against the single-device forward (bf16_atol); the
    table-wise, hot/cold tensor-parallel and hot/cold hybrid models
    (DIST_LAYOUT_PATHS) in the three layouts on the zipf stream, against the
    layout's single-device forward (bf16_atol); and the dense and sparse
    f32 steps on DIST_TRAIN_AXES, whose losses are held here to the
    single-process mesh trainer's on the same weights and batches
    (TRAIN_LOSS_RTOL). In the children every launch of K1's, K1-int8's,
    K4's, K1b's and K5's windows, of K1, K1-int8 and K4 on a table-wise
    shard and of K6's shard modes is held to its plain version; their
    launches are this phase's. The walls are CUDA-event times of DIST_TIMED
    calls in each child: two processes on one card, collectives through the
    host over gloo, so they show no scaling. Returns the results and the
    launches."""
    t0 = time.perf_counter()
    cfg = zoo.get_config("rm1", table_scale=TABLE_SCALE)
    start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    gen = RecDataGenerator(cfg, seed=1)
    hosts = [gen.generate_batch(TRAIN_BATCH) for _ in range(DIST_STEPS)]
    want = {}
    for mode in ("dense", "sparse"):
        tr = port_train.Trainer(cfg, mesh=_cuda_mesh(device, *DIST_TRAIN_AXES),
                                optimizer="adagrad", learning_rate=MESH_TRAIN_LR,
                                sparse_tables=mode == "sparse", params=start)
        want[mode] = [float(tr.step(h, tr._labels(h, None))) for h in hosts]
        del tr
        _free(device)
    del start
    _free(device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=dist_child, args=(r, port, str(device), TABLE_SCALE, q))
             for r in range(DIST_PROCS)]
    for proc in procs:
        proc.start()
    results = {}
    try:
        for _ in procs:
            rank, status, detail = q.get(timeout=DIST_WAIT_S)
            if status != "ok":
                raise AssertionError(f"phase 18 process {rank} failed:\n{detail}")
            results[rank] = detail
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    launches = _want()
    errs: dict = {}
    for rank, res in sorted(results.items()):
        _add(launches, res["launches"])
        for key, err in res["errs"].items():
            _merge(errs, key, err)
        for mode, tr in res["train"].items():
            rel = float(np.max(np.abs(np.asarray(tr["losses"]) - want[mode])
                               / np.abs(want[mode])))
            if not (np.all(np.isfinite(tr["losses"])) and rel <= TRAIN_LOSS_RTOL):
                raise AssertionError(f"phase 18 {mode} on process {rank}: losses {tr['losses']} "
                                     f"against the single-process mesh's {want[mode]}")
            tr["rel"] = rel
    def by_process(get, fmt: str) -> str:
        return ", ".join(format(get(res), fmt) for _, res in sorted(results.items()))

    for key in results[0]["fwd"]:
        _log(f"[18 processes] rm1 bf16 batch {BATCH} sharded_apply, {key} tables, across "
             f"{DIST_PROCS} processes: max |err| against the single-device forward by process "
             f"{by_process(lambda r: r['fwd'][key]['max_abs_err'], '.3e')} (limit bf16_atol); "
             f"wall {by_process(lambda r: r['fwd'][key]['wall_ms'], '.4f')} ms a forward by "
             f"process, {by_process(lambda r: r['fwd'][key]['collectives'], '.1f')} collective "
             f"calls a forward ({DIST_LABEL}) [{card}]")
    for key in results[0]["paths"]:
        _log(f"[18 processes] rm1 bf16 batch {BATCH} on zipf(1.2) ids, {key} across "
             f"{DIST_PROCS} processes: max |err| against the layout's single-device forward by "
             f"process {by_process(lambda r: r['paths'][key]['max_abs_err'], '.3e')} (limit "
             f"bf16_atol); wall {by_process(lambda r: r['paths'][key]['wall_ms'], '.4f')} ms a "
             f"forward by process, {by_process(lambda r: r['paths'][key]['collectives'], '.1f')} "
             f"collective calls a forward ({DIST_LABEL}); kernel us by process and route "
             + "; ".join(f"{rank}: " + ", ".join(f"{route} {_us(ms)}" for route, ms in
                                                 res["paths"][key]["kernel_ms"].items())
                         for rank, res in sorted(results.items()))
             + f" [{card}]")
    for mode in want:
        _log(f"[18 processes] rm1 {mode} f32 batch {TRAIN_BATCH} on "
             f"{DIST_TRAIN_AXES[0]}x{DIST_TRAIN_AXES[1]} across {DIST_PROCS} processes: losses "
             f"{', '.join(f'{x:.6f}' for x in results[0]['train'][mode]['losses'])} against the "
             f"single-process mesh's {', '.join(f'{x:.6f}' for x in want[mode])} (max relative "
             f"error by process {by_process(lambda r: r['train'][mode]['rel'], '.2e')}, limit "
             f"{TRAIN_LOSS_RTOL:.0e}); wall {by_process(lambda r: r['train'][mode]['wall_ms'], '.4f')}"
             f" ms a step by process, "
             f"{by_process(lambda r: r['train'][mode]['collectives'], '.1f')} collective calls "
             f"a step ({DIST_LABEL}) [{card}]")
    _log(f"[18 processes] every window launch in the children within its plain version (max "
         f"|err| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}); launches "
         f"{_nonzero(launches)}; phase 18 in {time.perf_counter() - t0:.1f} s [{card}]")
    return {"results": results, "want": want, "errs": errs}, launches


def _nccl_path(device, mesh, mode: str, table_scale: int, errs: dict) -> tuple[dict, dict]:
    """One path of phase 18's nccl part in this child: rm1 ("dense",
    "sparse" or "sparse bf16": bf16 params) adagrad on ``mesh``, whose
    entries here are this process's one card, in two arms from the same
    weights on the same batches: the trainer's programs, which it is built
    without (``NCCL_SLOWER``) and takes here (``take_programs``: the first
    step eager, then a graph of the step with its NCCL collectives,
    replayed), and its step function called eagerly. The arms agree within the GRAPH_*
    limits (``check_graph_agreement``) and make this process's launches
    (K1's window once a local entry a step, K1b's too on a dense step, K5's
    once a shard whose entry (0, m) is here, K10 once); no kernel wrapper is
    called from Python over the replays. One more eager step holds K5's
    window to its plain version (sparse). Then the arms timed in turns
    (``nccl_step_probe.turn_walls``: graphed, eager, eager, graphed,
    DIST_NCCL_TIMED steps a turn, every process entering each turn at a
    barrier; the median step, its loss read back), and the collective calls
    of an eager step. Returns the results and the graphed arm's launches."""
    import torch.distributed as dist

    D, M = mesh.shape["data"], mesh.shape["model"]
    sparse, bf16 = mode != "dense", mode == "sparse bf16"
    cfg = zoo.get_config("rm1", table_scale=table_scale,
                         **(dict(param_dtype="bfloat16") if bf16 else {}))
    start = get_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    n = len(mesh.all_ranks)
    what = f"rm1 {mode} {D}x{M} across {n} processes over nccl, a card each"
    kw = dict(optimizer="adagrad", learning_rate=GRAPH_LR["adagrad"], sparse_tables=sparse,
              params=start)
    tr, ev = (port_train.Trainer(cfg, mesh=mesh, **kw) for _ in range(2))
    del start
    if tr.eager_reason != NCCL_SLOWER or tr.step_program is not None:
        raise AssertionError(f"{what}: built with eager reason {tr.eager_reason!r}, not the "
                             "nccl replays' measured slowdown")
    tr.take_programs()  # its graphs, to hold them to the eager step and time both
    if tr.eager_reason is not None or tr.step_program is None or tr.step_program.cut is not None:
        raise AssertionError(f"{what}: the trainer takes no program of one graph "
                             f"({tr.eager_reason})")
    gen = RecDataGenerator(cfg, seed=1)
    args = [(h, tr._labels(h, None)) for h in
            (gen.generate_batch(TRAIN_BATCH) for _ in range(GRAPH_STEPS))]

    def graphed(h, lab):
        return tr.step(h, lab)

    def eager(h, lab):
        return ev._step(ev.params, ev.opt_state, h.to(device), ev._targets(lab))

    local = sum(mesh.is_local(d, m) for d in range(D) for m in range(M))
    owners = [m for m in range(M) if mesh.is_local(0, m)]
    want = _want(embedding_bag_shard=local * GRAPH_STEPS,
                 embedding_bag_backward_shard=0 if sparse else local * GRAPH_STEPS,
                 sparse_adagrad_step_shard=len(owners) * GRAPH_STEPS if sparse else 0,
                 optimizer_update=GRAPH_STEPS)
    _reset_counts()
    with _PythonLaunches() as py:
        losses_g = [float(graphed(*args[0]))]
        first = py.n
        losses_g += [float(graphed(*a)) for a in args[1:]]
    synchronize(device)
    counts_g = _counts()
    _reset_counts()
    with _collectives() as coll:
        losses_e = [float(eager(*a)) for a in args]
    synchronize(device)
    counts_e = _counts()
    progs = tr.step_program
    if counts_g != want or counts_e != want or py.n != first or progs.captures != 1:
        raise AssertionError(f"{what}: launches graphed {_nonzero(counts_g)}, eager "
                             f"{_nonzero(counts_e)}, expected {_nonzero(want)}; "
                             f"{py.n - first} from Python over the replays; "
                             f"{progs.captures} captures")
    accs = ([(tr.opt_state[1].part(0, m), ev.opt_state[1].part(0, m)) for m in owners]
            if sparse else ())
    agree = check_graph_agreement(what, losses_g, losses_e, tr.params, ev.params, "adagrad",
                                  sparse, GRAPH_STEPS, accs)
    if sparse:
        with _recorded(port_train, "sparse_adagrad_step_shard", _k5_pre) as calls:
            eager(*args[0])
        err = _check_k5(calls, what, True)
        _merge(errs, "sparse_adagrad_step_shard", err)
        if bf16:
            _merge(errs, "sparse_adagrad_step_shard bf16", err)
        del calls
    turns = turn_walls({"graphed": graphed, "eager": eager}, args, DIST_NCCL_TIMED,
                       lambda: dist.barrier(device_ids=[device.index]), device)
    walls = {arm: t["median_ms"] for arm, t in turns.items()}
    pool = progs.pool_bytes()
    res = {"losses": losses_g, "eager_losses": losses_e, **agree, "wall_ms": walls,
           "collectives": coll[0] / GRAPH_STEPS, "captures": progs.captures,
           "capture_ms": progs.capture_ms, "pool_mib": pool / 2**20,
           "launches": _nonzero({k: v // GRAPH_STEPS for k, v in counts_g.items()}),
           "k5_window_launches": counts_g["sparse_adagrad_step_shard"]}
    del tr, ev
    _free(device)
    return res, counts_g


def nccl_child(rank: int, n_procs: int, paths: tuple, port: int, table_scale: int, q):
    """One of ``n_procs`` processes of phase 18's nccl part (spawned), on
    card ``rank``: joins the group over nccl, runs ``_nccl_path`` for each
    mesh of ``paths`` and mode of DIST_NCCL_MODES, and puts ``(rank, "ok",
    results)`` (or ``"error"`` with the traceback; the parent then kills
    every child, so none waits in a collective for a process that failed)."""
    import torch.distributed as dist

    try:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        distributed_init(f"127.0.0.1:{port}", num_processes=n_procs, process_id=rank,
                         backend="nccl")
        errs, launches, out = {}, _want(), {}
        for D, M in paths:
            mesh = make_mesh(D, M, devices=[device])
            for mode in DIST_NCCL_MODES:
                res, counts = _nccl_path(device, mesh, mode, table_scale, errs)
                out[f"rm1 {mode} {D}x{M}"] = res
                _add(launches, counts)
        q.put((rank, "ok", {"paths": out, "errs": errs, "launches": launches}))
    except Exception:  # the parent raises it
        q.put((rank, "error", traceback.format_exc()[-4000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_dist_nccl(device, card: str) -> tuple[dict, dict, dict]:
    """Phase 18's part over nccl: for each number of processes in
    DIST_NCCL_PATHS that the machine's cards hold, that many spawned
    children, each on a card of its own (``nccl_child``), every path's
    graphed steps held to its eager steps there; here every child's losses
    must be the same, and one line a path gives the walls of both arms by
    process, the losses apart, the collectives a step, the captures,
    capture ms and graph pool. With fewer cards a line says the part did
    not run. Returns the results, the children's launches and their
    kernels' max |err|."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    out, launches, errs = {}, _want(), {}
    _free(device)
    for n_procs, paths in DIST_NCCL_PATHS.items():
        if n < n_procs:
            _log(f"[18 processes nccl] {n_procs} processes of a card each need {n_procs} cards; "
                 f"this machine has {n}: not run [{card}]")
            continue
        t0 = time.perf_counter()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=nccl_child, args=(r, n_procs, paths, port, TABLE_SCALE, q))
                 for r in range(n_procs)]
        for proc in procs:
            proc.start()
        results = {}
        try:
            deadline = time.monotonic() + DIST_NCCL_WAIT_S
            for _ in procs:
                rank, status, detail = q.get(timeout=max(1.0, deadline - time.monotonic()))
                if status != "ok":
                    raise AssertionError(f"phase 18 nccl process {rank} of {n_procs} "
                                         f"failed:\n{detail}")
                results[rank] = detail
        finally:
            failed = len(results) < n_procs
            for proc in procs:
                if failed:
                    proc.kill()
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=10)
        for rank, res in sorted(results.items()):
            _add(launches, res["launches"])
            for key, err in res["errs"].items():
                _merge(errs, key, err)
        for key in results[0]["paths"]:
            rs = [results[r]["paths"][key] for r in sorted(results)]
            if any(r["losses"] != rs[0]["losses"] for r in rs):
                raise AssertionError(f"phase 18 nccl {key}: the processes' losses differ: "
                                     f"{[r['losses'] for r in rs]}")
            out[key] = rs

            def by(get, fmt):
                return ", ".join(format(get(r), fmt) for r in rs)

            _log(f"[18 processes nccl] {key} across {n_procs} processes, a card each, batch "
                 f"{TRAIN_BATCH}: graphed and eager agree over {GRAPH_STEPS} steps (losses max "
                 f"relative {max(r['loss_rel'] for r in rs):.2e}, limit "
                 f"{rs[0]['loss_rtol']:.0e}; params {max(r['param_share'] for r in rs):.3f} of "
                 f"their limits), every process's losses equal; median ms a step by process "
                 f"in turns, loss read back: graphed {by(lambda r: r['wall_ms']['graphed'], '.4f')}, eager "
                 f"{by(lambda r: r['wall_ms']['eager'], '.4f')}; "
                 f"{by(lambda r: r['collectives'], '.1f')} collective calls an eager step; "
                 f"{by(lambda r: r['captures'], 'd')} captures, capture ms "
                 f"{by(lambda r: r['capture_ms'], '.1f')}, graph pool MiB "
                 f"{by(lambda r: r['pool_mib'], '.1f')}; launches a step on process 0 "
                 f"{rs[0]['launches']} [{card}]")
        _log(f"[18 processes nccl] {n_procs} processes in {time.perf_counter() - t0:.1f} s "
             f"[{card}]")
    return out, launches, errs


# --------------------------------------------------- phase 19: the port's tools

def _first_checked(check, n: int = TOOL_CHECKED):
    """An ``after`` for ``_recorded`` that runs ``check`` on the first ``n``
    calls (from any thread) and returns None for the later ones."""
    seen, lock = [0], threading.Lock()

    def after(args, kw, out):
        with lock:
            seen[0] += 1
            if seen[0] > n:
                return None
        return check(args, kw, out)

    return after


def _worst(calls, what: str, kernel: str) -> float:
    errs = [c[3] for c in calls if c[3] is not None]
    if not errs:
        raise AssertionError(f"{what}: no launch of {kernel} was held to its plain version")
    return max(errs)


def _k1_err(what: str):
    """An ``after`` for ``embedding_bag``: K1's pooled output against
    ``embedding_bag_reference`` on the same table and ids (on the calling
    thread's stream), within ``pooled_tolerance``. Returns the max |err|."""
    def check(args, kw, out):
        table, offsets, indices = args[:3]
        mask = kw.get("mask")
        with torch.no_grad():
            want = embedding_bag_reference(table, offsets, indices, mask=mask,
                                           compute_dtype=kw.get("compute_dtype"))
            return _check_pooled(out.detach(), want, table, offsets, indices, mask, what)

    return check


def _k6_err(what: str, reference):
    """An ``after`` for ``embedding_bag_hotcold``: K6's output against its
    plain version (``reference``, the unpatched one) on the same split,
    within ``hotcold_tolerance``. Returns the max |err|."""
    def check(args, kw, out):
        hot, table, split = args[:3]
        with torch.no_grad():
            got = out.detach()
            want = reference(hot, table, split, compute_dtype=kw.get("compute_dtype"))
            err = (got.float() - want.float()).abs()
            tol = hotcold_tolerance(got, want, hot, table, split)
        if not bool((err <= tol).all()):
            raise AssertionError(f"K6 disagrees with its plain version ({what}): max |err| "
                                 f"{err.max().item():.3e}, {int((err > tol).sum())} over")
        return err.max().item()

    return check


@contextlib.contextmanager
def _plain_calls(module, name: str):
    """Calls of the plain version ``module.<name>`` made inside the block,
    counted (a list of one count)."""
    orig, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _tool(tool, name: str, argv: list) -> tuple[dict, dict]:
    """``tool.main(argv)`` with its record at TOOLS_OUT/phase19_<name>.json
    and the launch counts set to 0 just before and read just after."""
    out = TOOLS_OUT / f"phase19_{name}.json"
    _reset_counts()
    rec = tool.main(argv + ["--out", str(out)])
    counts = _counts()
    if json.loads(out.read_text())["card"] != rec["card"]:
        raise AssertionError(f"{name}: the record at {out} is not the run's")
    return rec, counts


def tool_cpu_mp_soak(device, card: str, errs: dict) -> tuple[dict, dict]:
    """``cpu_mp_soak --accel`` for TOOL_SOAK_MINUTES: two cpu-mp engine
    processes and the offload engine on ``device``, one exhaustion cycle.
    0 errors, every cycle 503s then a recovered 200, 0 slots leaked (the
    arena and /v1/healthz), both /v1/infer routes served, and K1's launches
    here the offload engine's executions, the first TOOL_CHECKED held to
    the plain version."""
    what = "cpu_mp_soak --accel, the offload engine"
    with _recorded(port_ops, "embedding_bag", after=_first_checked(_k1_err(what))) as k1:
        rec, counts = _tool(tool_soak, "cpu_mp_soak", [
            "--accel", "--minutes", str(TOOL_SOAK_MINUTES), "--sample-s", str(TOOL_SAMPLE_S),
            "--first-exhaustion-s", str(TOOL_SAMPLE_S), "--device", str(device)])
    errs["embedding_bag"] = _worst(k1, what, "K1")
    cycles = rec["exhaustion_cycles"]
    if (rec["n_errors"] or not cycles
            or not all(c["n_503"] >= 1 and c["recovered_200"] for c in cycles)
            or rec["slots_leaked_at_quiesce"] != 0
            or rec["payload_slots_in_flight_at_quiesce"] != 0
            or rec["infer_accel_ok"] == 0 or rec["infer_child_ok"] == 0
            or rec["predict_ok"] == 0):
        summary = {k: v for k, v in rec.items() if k != "samples"}
        raise AssertionError(f"cpu_mp_soak: {json.dumps(summary)}")
    if counts != _want(embedding_bag=rec["accel_executions"]):
        raise AssertionError(f"cpu_mp_soak: launches {_nonzero(counts)} for the offload "
                             f"engine's {rec['accel_executions']} executions")
    last = rec["samples"][-1]
    _log(f"[19 tools] cpu_mp_soak --accel ({rec['model']}, 2 engine processes + the offload "
         f"engine on {device}, {rec['clients']} clients, {rec['minutes']} min): "
         f"{rec['predict_ok']} predicts, {rec['infer_accel_ok']} offloaded and "
         f"{rec['infer_child_ok']} child /v1/infer, {rec['n_errors']} errors, "
         f"{rec['client_503s']} client 503s; exhaustion cycles "
         + "; ".join(f"{c['slots_staged']} slots staged, {c['n_503']} 503s, recovered "
                     f"{c['recovered_200']}" for c in cycles)
         + f"; {rec['slots_leaked_at_quiesce']} slots leaked; RSS first/second half "
         f"{rec['rss_first_half_mb']:.1f}/{rec['rss_second_half_mb']:.1f} MB; predict p50/p95 "
         f"{last['p50_ms']:.3f}/{last['p95_ms']:.3f} ms; K1 {counts['embedding_bag']} launches = "
         f"the offload engine's executions, the first {TOOL_CHECKED} max |err| "
         f"{errs['embedding_bag']:.3e} [{card}]")
    return rec, counts


def tool_ragged_hotcold_soak(device, card: str, errs: dict) -> tuple[dict, dict]:
    """``ragged_hotcold_soak`` for TOOL_SOAK_MINUTES on ``device`` (rm3,
    table_scale 100, hot/cold): 0 errors, at least TOOL_MIN_REFRESHES
    refreshes, K6 launched and its plain version never called by the path,
    the first TOOL_CHECKED launches held to it, a clean shutdown."""
    what = "ragged_hotcold_soak, rm3 hot/cold"
    reference = emb_mod.embedding_bag_hotcold_reference
    with _plain_calls(emb_mod, "embedding_bag_hotcold_reference") as plain, \
            _recorded(port_ops, "embedding_bag_hotcold",
                      after=_first_checked(_k6_err(what, reference))) as k6:
        rec, counts = _tool(tool_ragged, "ragged_hotcold_soak", [
            "--minutes", str(TOOL_SOAK_MINUTES), "--sample-s", str(TOOL_SAMPLE_S),
            "--phase-requests", str(TOOL_PHASE_REQUESTS), "--device", str(device)])
    errs["embedding_bag_hotcold"] = _worst(k6, what, "K6")
    if (rec["errors"] or rec["requests_ok"] == 0 or rec["hot_refreshes"] < TOOL_MIN_REFRESHES
            or not rec["clean_shutdown"] or counts["embedding_bag_hotcold"] == 0 or plain[0]):
        raise AssertionError(f"ragged_hotcold_soak: {rec['requests_ok']} ok, {rec['errors']} "
                             f"errors, {rec['hot_refreshes']} refreshes, clean shutdown "
                             f"{rec['clean_shutdown']}, launches {_nonzero(counts)}, plain "
                             f"version called {plain[0]} times")
    _log(f"[19 tools] ragged_hotcold_soak (rm3 table_scale {rec['table_scale']}, hot/cold, "
         f"{rec['clients']} clients, batch {rec['batch']}, head rotated every "
         f"{rec['phase_requests']} requests, {rec['minutes']} min, on {device}): "
         f"{rec['requests_ok']} ragged predicts, {rec['errors']} errors, {rec['hot_refreshes']} "
         f"refreshes, p50/p95 {rec['p50_ms']:.3f}/{rec['p95_ms']:.3f} ms, max RSS "
         f"{rec['rss_start_mb']:.0f} -> {rec['rss_end_mb']:.0f} MB, clean shutdown; launches "
         f"{_nonzero(counts)}, the plain K6 never called; the first {TOOL_CHECKED} K6 max |err| "
         f"{errs['embedding_bag_hotcold']:.3e} [{card}]")
    return rec, counts


def tool_mesh_bench(device, card: str, errs: dict) -> tuple[dict, dict]:
    """``mesh_bench`` on each of TOOL_MESHES for rm1 at table_scale 1: the
    record virtual on one card, samples/s > 0, K1's window D*M times a
    forward (the first TOOL_CHECKED held to its plain version), and the
    descriptor counters within the JAX test's law."""
    launches, out = _want(), {}
    for D, M in TOOL_MESHES:
        what = f"mesh_bench rm1 {D}x{M}"
        with _recorded(port_ops, "embedding_bag_shard",
                       after=_first_checked(_k1_window_err(what))) as k1:
            rec, counts = _tool(tool_mesh, f"mesh_bench_{D}x{M}", [
                "--mesh", f"{D}x{M}", "--models", "rm1", "--table-scale", str(TABLE_SCALE),
                "--device", str(device)])
        _merge(errs, "embedding_bag_shard", _worst(k1, what, "K1's window"))
        r = rec["results"]["rm1"]
        one_card = device.type == "cuda" and torch.cuda.device_count() < D * M
        if (rec["virtual"] != (one_card or device.type == "cpu") or not r["samples_per_s"] > 0
                or (one_card and "virtual shards of one card" not in rec["label"])):
            raise AssertionError(f"{what}: virtual {rec['virtual']} ({rec['label']}), "
                                 f"{r['samples_per_s']} samples/s")
        _mesh_launch_check(counts, _want(embedding_bag_shard=D * M * r["forwards"]), what)
        for key, v in rec["descriptor_counters"]["rm1"].items():
            d, m = (int(x) for x in key.split("x"))
            flat = [x for row in v["per_chip_descriptors"] for x in row]
            if (v["max_chip_descriptors"] > max(v["ideal_per_chip"] * 1.5, 8)
                    or sum(flat) != v["n_cold_total"] or len(flat) != d * m):
                raise AssertionError(f"{what}: splitter {key} {v}")
        _add(launches, counts)
        out[f"{D}x{M}"] = rec
        _log(f"[19 tools] {what} ({rec['label']}), bf16 batch {rec['batch']}: "
             f"{r['latency_ms']:.4f} ms a forward (loops of {(r['forwards'] - 1) // 2}: "
             + ", ".join(f"{t:.4f}" for t in r["trials_ms"])
             + f"), {r['samples_per_s']:.1f} samples/s, first call {r['first_call_s']:.2f} s; "
             f"launches {_nonzero(counts)}; splitter max / ideal descriptors a shard "
             + ", ".join(f"{k} {v['max_chip_descriptors']} / {v['ideal_per_chip']:.1f}"
                         for k, v in rec["descriptor_counters"]["rm1"].items())
             + f" [{card}]")
    return out, launches


@contextlib.contextmanager
def _runs_of(module):
    """Each ``module.run_serving`` call inside the block, with the launch
    counts set to 0 just before it and read just after: a list of
    ``(engine_backend, counts, result)``."""
    orig, runs = module.run_serving, []

    def run(model_cfg, serving_cfg, *args, **kwargs):
        _reset_counts()
        res = orig(model_cfg, serving_cfg, *args, **kwargs)
        runs.append((serving_cfg.engine_backend, _counts(), res))
        return res

    module.run_serving = run
    try:
        yield runs
    finally:
        module.run_serving = orig


def tool_sim_revalidate(device, card: str, errs: dict) -> tuple[dict, dict]:
    """``sim_revalidate rm1``: the real half served on the card (K1 once an
    execution, the first TOOL_CHECKED held to the plain version), the sim
    half over the card's ladder launching no kernel; both p95s and the
    relative error."""
    what = "sim_revalidate rm1, the real half"
    with _runs_of(tool_sim) as runs, \
            _recorded(port_ops, "embedding_bag", after=_first_checked(_k1_err(what))) as k1:
        rec, _ = _tool(tool_sim, "sim_revalidate", [
            "rm1", "--table-scale", str(TABLE_SCALE), "--device", str(device)])
    _merge(errs, "embedding_bag", _worst(k1, what, "K1"))
    ((real_backend, real_counts, real), (sim_backend, sim_counts, _)) = runs
    counts = _want()  # each half's, read around its own run
    _add(counts, real_counts)
    _add(counts, sim_counts)
    want_backend = "gpu" if device.type == "cuda" else "cpu"
    if (real_backend != want_backend or real_counts != _want(embedding_bag=real.executions)
            or real.executions == 0 or sim_backend != "sim" or sim_counts != _want()):
        raise AssertionError(f"sim_revalidate: real half {real_backend} launches "
                             f"{_nonzero(real_counts)} for {real.executions} executions; sim "
                             f"half {sim_backend} launches {_nonzero(sim_counts)}")
    r = rec["results"]["rm1"]
    if not (np.isfinite(r["p95_rel_err"]) and r["sim"]["n"] == r["real"]["n"] > 0):
        raise AssertionError(f"sim_revalidate: {r}")
    _log(f"[19 tools] sim_revalidate rm1 (table_scale {r['table_scale']}, {r['dtype']}, the "
         f"JAX sim-validation point: arrivals 60 ms apart, sizes ~N(165, 16), sub-batch 64), "
         f"ladder measured on {r['ladder']['device']}, {r['ladder']['power_limit']}: real on "
         f"{device} QPS {r['real']['qps']:.2f} p50/p95 {r['real']['p50_ms']:.3f}/"
         f"{r['real']['p95_ms']:.3f} ms, sim QPS {r['sim']['qps']:.2f} p50/p95 "
         f"{r['sim']['p50_ms']:.3f}/{r['sim']['p95_ms']:.3f} ms: p95 relative error "
         f"{r['p95_rel_err']:+.4f}, p50 {r['p50_rel_err']:+.4f}; real launches "
         f"{_nonzero(real_counts)} = {real.executions} executions, sim launches none [{card}]")
    return rec, counts


def tool_refresh_scan_cost(device, card: str) -> tuple[dict, dict]:
    """``refresh_scan_cost --models rm1``: host numpy, no launch."""
    rec, counts = _tool(tool_scan, "refresh_scan_cost", [
        "--models", "rm1", "--table-scale", str(TABLE_SCALE), "--device", str(device)])
    r = rec["results"]["rm1"]
    if counts != _want() or not (r["uncapped_ms"] > 0 and r["capped_ms"] > 0):
        raise AssertionError(f"refresh_scan_cost: {r}, launches {_nonzero(counts)}")
    _log(f"[19 tools] refresh_scan_cost rm1 (window {r['window']} x {r['batch']}, "
         f"{r['lookups_scanned_M']:.4f} M ids, hot set {r['hot_rows_k']} rows, budget "
         f"{r['budget']}; host numpy): uncapped {r['uncapped_ms']:.1f} ms, capped "
         f"{r['capped_ms']:.1f} ms; holdout coverage of the uncapped set "
         f"{r['coverage_uncapped_set']:.4f}, of the capped set "
         f"{r['coverage_capped_set_full_holdout']:.4f} [{card}]")
    return rec, counts


def phase_tools(device, card: str) -> tuple[dict, dict]:
    """Phase 19: the port's tools on ``device``, each from its ``main(argv)``
    and read back from its record, each path's launches read around it.
    Returns the records (with ``errs``: each kernel's max |err| over its
    checked launches) and the launches."""
    t0 = time.perf_counter()
    launches, errs, out = _want(), {}, {}
    for name, fn in (("cpu_mp_soak", tool_cpu_mp_soak),
                     ("ragged_hotcold_soak", tool_ragged_hotcold_soak),
                     ("mesh_bench", tool_mesh_bench), ("sim_revalidate", tool_sim_revalidate)):
        out[name], counts = fn(device, card, errs)
        _add(launches, counts)
        _free(device)
    out["refresh_scan_cost"], counts = tool_refresh_scan_cost(device, card)
    _add(launches, counts)
    out["errs"] = errs
    _log(f"[19 tools] launches {_nonzero(launches)}; records under {TOOLS_OUT}; phase 19 in "
         f"{time.perf_counter() - t0:.1f} s [{card}]")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    kernel_errs = phase_kernel(device)
    k3_errs = [rnn_cases(device, DIEN_T, BATCH, seed) for seed in range(K3_SEEDS)]
    k3_err = max(k3_errs)
    _log(f"[3 kernel] K3 at DIEN's shape, free-running max |err| by seed: "
         f"{', '.join(f'{e:.3e}' for e in k3_errs)}; worst {k3_err:.3e} = "
         f"{100 * k3_err / K3_BF16_ATOL:.1f}% of the bf16 limit {K3_BF16_ATOL:.3e}")
    widths, width_t, width_launches = phase_widths(device, card["card"])
    phase_fixture(device)

    # rm1's main path: the counts are set to 0 just before it and read just after.
    torch.cuda.reset_peak_memory_stats(device)
    _reset_counts()
    fwd = phase_forward(device)
    launches = _counts()
    if launches["embedding_bag"] == 0:
        raise AssertionError("the main path never launched K1")
    # The serving paths, each read around itself.
    serving, serve_launches = phase_serving(device, fwd, card["card"])
    _add(launches, serve_launches)
    torch.cuda.reset_peak_memory_stats(device)
    times = phase_times(device, fwd, card["card"])
    # The serving fabric's paths, each read around itself; phase 16's mesh
    # reload on its checkpoint.
    mesh_errs: dict = {}
    fabric, fabric_launches = phase_fabric(
        device, fwd, card["card"],
        on_checkpoint=lambda ckpt, new: mesh_reload(device, fwd, ckpt, new, card["card"],
                                                    mesh_errs))
    _add(launches, fabric_launches)
    mesh_launches = _want()
    mesh_reload_res, counts = fabric.pop("on_checkpoint")
    _add(mesh_launches, counts)
    # Phase 16: serving over meshes of the card, each path read around itself.
    mesh, counts = phase_mesh(device, fwd, times, serving["rm1_1"], card["card"], mesh_errs)
    _add(mesh_launches, counts)
    # Phase 16's engines over several cards (two cards or more), read around
    # themselves.
    mesh["cards"], counts = mesh_cards(device, fwd, card["card"], mesh_errs)
    _add(mesh_launches, counts)
    del fwd
    torch.cuda.empty_cache()

    # The other models' paths, each read around itself; phase 16's 1x4 mesh
    # on each while it lives.
    mesh_zoo_rows = []

    def on_model(z):
        row, counts = mesh_zoo(device, z, card["card"], mesh["errs"])
        mesh_zoo_rows.append(row)
        _add(mesh_launches, counts)

    rows, zoo_launches = phase_zoo(device, card["card"], on_model=on_model)
    _add(launches, zoo_launches)
    for key in list(SHARD.values()) + list(HOTCOLD_SHARD.values()):
        if mesh_launches[key] == 0:
            raise AssertionError(f"the mesh paths never launched {key}")
    _add(launches, mesh_launches)
    for key in LOOKUP.values():  # the direct kernels on the table-wise shards
        kernel_errs[key] = max(kernel_errs[key], mesh["errs"].get(key, 0.0))
    if launches["rnn_scan"] == 0:
        raise AssertionError("dien's path never launched K3")
    k3 = phase_rnn_times(device, card["card"])

    # The int8 tables' paths, each read around itself.
    quant, quant_launches = phase_quant(device, card["card"])
    _add(launches, quant_launches)

    # The hot/cold serving paths, each read around itself.
    hotcold, hotcold_launches = phase_hotcold(device, card["card"])
    _add(launches, hotcold_launches)
    for key in HOTCOLD.values():
        if launches[key] == 0:
            raise AssertionError(f"the hot/cold paths never launched {key}")
    hotcold_t = hotcold_times(device, card["card"])
    skew = phase_skew(device, card["card"])

    # The trainer's paths, each read around itself.
    trained, train_launches, steps = phase_train(device, card["card"])
    _add(launches, train_launches)
    for key in ("embedding_bag_backward", "sparse_adagrad_step", "rnn_scan_backward",
                "optimizer_update", "embedding_bag_int8", "embedding_bag_int8_rowwise"):
        if launches[key] == 0:
            raise AssertionError(f"the training or int8 paths never launched {key}")

    # Phase 17: training over meshes of the card, each path read around itself.
    mesh_train, mesh_train_launches = phase_mesh_train(device, card["card"])
    for key in ("embedding_bag_backward_shard", "sparse_adagrad_step_shard"):
        if mesh_train_launches[key] == 0:
            raise AssertionError(f"the mesh training paths never launched {key}")
    _add(launches, mesh_train_launches)
    mesh["errs"]["embedding_bag_shard"] = max(mesh["errs"]["embedding_bag_shard"],
                                              mesh_train["errs"]["embedding_bag_shard"])

    # Phase 18: a mesh across processes, read around itself in its children;
    # its part over nccl (two cards or more) too.
    dist_res, dist_launches = phase_dist(device, card["card"])
    dist_res["nccl"], nccl_launches, nccl_errs = phase_dist_nccl(device, card["card"])
    _add(dist_launches, nccl_launches)
    for key, err in nccl_errs.items():
        _merge(dist_res["errs"], key, err)
    # K5's window on a bf16 shard, on the main paths: phase 17's bf16 steps
    # (the graphed arms, one card and over cards) and phase 18's over nccl.
    bf16_launches = mesh_train["bf16_launches"] + sum(
        r["k5_window_launches"] for key, rs in dist_res["nccl"].items() if "bf16" in key
        for r in rs)
    if bf16_launches == 0:
        raise AssertionError("the bf16 sparse mesh paths never launched K5's bf16 window")
    bf16_err = max(mesh_train["errs"].get("sparse_adagrad_step_shard bf16", 0.0),
                   dist_res["errs"].get("sparse_adagrad_step_shard bf16", 0.0),
                   mesh_train["times"]["sparse_adagrad_step_shard bf16"]["max_abs_err"])
    for key in ("embedding_bag_shard", "embedding_bag_backward_shard",
                "sparse_adagrad_step_shard", *(SHARD[q] for q in QUANT_MODES),
                *LOOKUP.values(), *HOTCOLD_SHARD.values()):
        if dist_launches[key] == 0:
            raise AssertionError(f"the multi-process paths never launched {key}")
    _add(launches, dist_launches)
    for key in ("embedding_bag_shard", *(SHARD[q] for q in QUANT_MODES),
                *HOTCOLD_SHARD.values()):
        mesh["errs"][key] = max(mesh["errs"].get(key, 0.0), dist_res["errs"][key])
    for key in LOOKUP.values():  # the direct kernels on the table-wise shards
        kernel_errs[key] = max(kernel_errs[key], dist_res["errs"][key])
    for key in ("embedding_bag_backward_shard", "sparse_adagrad_step_shard"):
        mesh_train["errs"][key] = max(mesh_train["errs"][key], dist_res["errs"][key])
    trained["sparse_adagrad_step"]["max_abs_err"] = max(
        trained["sparse_adagrad_step"]["max_abs_err"], mesh_train["errs"]["sparse_adagrad_step"])

    # The data modes' and the experiments' paths, each read around itself.
    data, data_launches = phase_data(device, card["card"], times["k1"],
                                     serving["rm1_1"]["p95_ms"])
    _add(launches, data_launches)
    kernel_errs["embedding_bag"] = max(kernel_errs["embedding_bag"],
                                       data["errs"]["embedding_bag"])
    k3_err = max(k3_err, data["errs"]["rnn_scan"])
    trained["sparse_adagrad_step"]["max_abs_err"] = max(
        trained["sparse_adagrad_step"]["max_abs_err"], data["errs"]["sparse_adagrad_step"])

    # Phase 19: the port's tools, each path read around itself.
    tools, tool_launches = phase_tools(device, card["card"])
    for key in ("embedding_bag", "embedding_bag_hotcold", "embedding_bag_shard"):
        if tool_launches[key] == 0:
            raise AssertionError(f"the tools' paths never launched {key}")
    _add(launches, tool_launches)
    kernel_errs["embedding_bag"] = max(kernel_errs["embedding_bag"],
                                       tools["errs"]["embedding_bag"])
    hotcold["errs"]["embedding_bag_hotcold"] = max(hotcold["errs"]["embedding_bag_hotcold"],
                                                   tools["errs"]["embedding_bag_hotcold"])
    mesh["errs"]["embedding_bag_shard"] = max(mesh["errs"]["embedding_bag_shard"],
                                              tools["errs"]["embedding_bag_shard"])

    _log(f"[10 summary] per model, bf16, batch {BATCH}, full-size tables [{card['card']}]:")
    _log("[10 summary]   model: forward wall ms, device ms, idle, K1 us (% of 3.35 TB/s, "
         "counting each distinct row once), K1 bound us, F.embedding_bag us, K1 plain us, "
         "peak GiB")
    rm1 = {"name": "rm1", "fwd_wall_ms": times["fwd_wall_ms"], "k1": times["k1"],
           "fwd_device_ms": times["fwd_device_ms"], "peak_bytes": times["peak_bytes"]}
    for r in [rm1] + rows:
        dev = r["fwd_device_ms"]
        idle = "not measured" if dev is None else f"{100 * (1 - dev / r['fwd_wall_ms']):.1f}%"
        _log(f"[10 summary]   {r['name']}: {r['fwd_wall_ms']:.4f}, "
             f"{'not measured' if dev is None else f'{dev:.4f}'}, {idle}, "
             f"{r['k1']['ms'] * 1e3:.2f} ({100 * r['k1']['hbm_share']:.1f}%), "
             f"{r['k1']['bound_ms'] * 1e3:.2f}, {r['k1']['library_ms'] * 1e3:.2f}, "
             f"{r['k1']['plain_ms'] * 1e3:.2f}, {r['peak_bytes'] / 2**30:.3f} [{card['card']}]")
    _log("[10 summary] serving, canonical point (sizes ~N(165, 16), sub-batch 32, 10 ms "
         "mean gap): engines, queries, QPS, p50/p95/p99 ms, queue-wait p95 ms, inference "
         "p95 ms, pacing error mean/p99 ms, peak GiB")
    for key in ("rm1_1", "rm1_4", "dien"):
        s = serving[key]
        _log(f"[10 summary]   {key.split('_')[0]}: {s.get('engines', 1)}, {s['cpu_requests']}, "
             f"{s['measured_qps']:.2f}, {s['p50_ms']:.3f}/{s['p95_ms']:.3f}/{s['p99_ms']:.3f}, "
             f"{s['queue_wait_p95_ms']:.3f}, {s['inference_p95_ms']:.3f}, "
             f"{s['pacing_error_mean_ms']:.4f}/{s['pacing_error_p99_ms']:.4f}, "
             f"{s['peak_gib']:.3f} [{card['card']}]")
    _log("[10 summary] the engines' CUDA graphs, canonical ladder, bf16 full size: engine: "
         "programs, graphs captured, capture ms, graph pool MiB, max |err| of the first replays")
    for what, r in serving["programs"].items():
        pool = "not measured" if r["pool_bytes"] is None else f"{r['pool_bytes'] / 2**20:.1f}"
        _log(f"[10 summary]   {what}: {r['programs']}, {r['captures']}, {r['capture_ms']:.1f}, "
             f"{pool}, {r['max_abs_err']:.3e} [{card['card']}]")
    for engines, r in serving["capacity"].items():
        idle = "not measured" if r.get("idle_share") is None else f"{r['idle_share']:.1%}"
        _log(f"[10 summary]   rm1 closed loop, {engines} engine(s), {CAPACITY_ROWS}-row "
             f"executions (traced): {r['executions_per_s']:.1f} executions/s, device idle "
             f"{idle} [{card['card']}]")
    _log("[10 summary] rm1 with int8 tables, bf16, batch 512, full-size tables: mode: forward "
         "wall ms, device ms, idle, forward peak GiB; kernel us, bound us, plain us, K1 on a bf16 "
         "table us (same ids); served (1 engine): QPS, p50/p95/p99 ms, inference p95 ms, peak "
         "GiB")
    for mode, q in quant.items():
        s = q["serving"]
        dev = "not measured" if q["fwd_device_ms"] is None else f"{q['fwd_device_ms']:.4f}"
        idle = "not measured" if q["idle"] is None else f"{100 * q['idle']:.1f}%"
        _log(f"[10 summary]   {mode}: {q['fwd_wall_ms']:.4f}, {dev}, {idle}, "
             f"{q['peak_bytes'] / 2**30:.3f}; {q['ms'] * 1e3:.2f}, {q['bound_ms'] * 1e3:.2f}, "
             f"{q['plain_ms'] * 1e3:.2f}, {q['k1_bf16_ms'] * 1e3:.2f}; {s['measured_qps']:.2f}, "
             f"{s['p50_ms']:.3f}/{s['p95_ms']:.3f}/{s['p99_ms']:.3f}, "
             f"{s['inference_p95_ms']:.3f}, {s['peak_gib']:.3f} [{card['card']}]")
    _log("[10 summary] hot/cold serving, rm1 bf16, 1 engine, canonical point: run: queries, "
         "QPS, p50/p95/p99 ms, inference p95 ms, peak GiB, sampled hot-set coverage, split")
    for key in ("hotcold", "auto", "int8_rowwise", "int8"):
        s = hotcold["serving"][key]
        _log(f"[10 summary]   {key}: {s['cpu_requests']}, {s['measured_qps']:.2f}, "
             f"{s['p50_ms']:.3f}/{s['p95_ms']:.3f}/{s['p99_ms']:.3f}, "
             f"{s['inference_p95_ms']:.3f}, {s['peak_gib']:.3f}, {_coverage(s['hot_coverage'])}, "
             f"{s['split']} [{card['card']}]")
    r = hotcold["serving"]["refresh"]
    _log(f"[10 summary]   refresh on zipf payloads: {r['payloads']} payloads, hot_refreshes "
         f"{r['hot_refreshes']}, coverage {r['warm_coverage']:.4f} -> {r['hot_coverage']:.4f}, "
         f"live {r['live_hot_coverage']:.4f} [{card['card']}]")
    _log("[10 summary] skewed traffic (zipf 1.2, batch 512, bf16): model: direct / hot/cold "
         "forward us, K1 / K6 us (K1 on uniform ids), host split ms, coverage, auto's choice, "
         "direct / max(hot/cold, split)")
    for r in skew:
        _log(f"[10 summary]   {r['model']}: {r['xla_ms'] * 1e3:.2f} / {r['hotcold_ms'] * 1e3:.2f}, "
             f"{r['k1_ms'] * 1e3:.2f} / {r['k6_ms'] * 1e3:.2f} ({r['k1_uniform_ms'] * 1e3:.2f}), "
             f"{r['split_ms']:.3f}, {r['hot_coverage']:.4f}, {r['auto_impl']}, "
             f"{r['speedup']:.4f} [{card['card']}]")
    i, r, m = fabric["ingress"], fabric["reload"], fabric["cpu_mp"]
    _log(f"[10 summary] serving fabric, rm1 bf16: HTTP /v1/infer p50/p95 "
         f"{i['http_infer_p50_ms']:.3f}/{i['http_infer_p95_ms']:.3f} ms (in-process "
         f"{i['submit_p50_ms']:.3f}/{i['submit_p95_ms']:.3f}), /v1/predict "
         f"{i['http_predict_p50_ms']:.3f}/{i['http_predict_p95_ms']:.3f} (in-process "
         f"{i['predict_p50_ms']:.3f}/{i['predict_p95_ms']:.3f}); reload apply ms direct "
         f"{r['direct']['apply_ms']:.1f}, hot/cold {r['hotcold']['apply_ms']:.1f}, peak GiB "
         f"{r['direct']['peak_gib']:.3f}/{r['hotcold']['peak_gib']:.3f}, 0 failed; cpu-mp + "
         f"offload (table_scale {FABRIC_MP_SCALE}) QPS {m['measured_qps']:.2f}, p95 "
         f"{m['p95_ms']:.3f} ms, {m['accel_requests']} offloaded [{card['card']}]")
    _log("[10 summary] training step, f32, batch 128, full-size tables, the trainer's "
         "programs (CUDA graphs; with the device span and the ms a step when the loss is not "
         "read back) / its step function called eagerly: wall ms, device ms, idle; captures, "
         "capture ms, graph pool MiB; params' share of their agreement limit; peak GiB of both "
         "arms")
    for st in steps:
        _log(f"[10 summary]   {st['name']}: {_summary_arms(st)} [{card['card']}]")
    syn, cri, sim = data["synthetic"], data["criteo"], data["sim"]
    q, qps = data["train_qps"]["quality"], data["train_qps"]["qps"]
    _log(f"[10 summary] data modes and experiments, rm1 bf16 batch {BATCH}, full size: "
         f"synthetic host {syn['host_batch_ms']:.1f} ms a batch (first {syn['host_first_ms']:.1f}); "
         f"K1 trace ids {syn['k1']['ms'] * 1e3:.2f} us / uniform {syn['k1_uniform_ms'] * 1e3:.2f} "
         f"us; forward on trace ids {syn['fwd_wall_ms']:.4f} ms; criteo forward "
         f"{cri['fwd_wall_ms']:.4f} ms, K1 {cri['k1']['ms'] * 1e3:.2f} us (L = 1); sim p95 "
         f"{sim['sim_p95_ms']:.3f} ms (this process's ladder) / {sim['sim_fresh_p95_ms']:.3f} ms "
         f"(a fresh process's) / real {sim['real_p95_ms']:.3f} ms; train_planted AUC "
         f"{q['final_auc']:.4f} / Bayes {q['bayes_auc']:.4f}, {q['steps_per_s']:.2f} steps/s; "
         f"latency-bounded QPS on gpu {qps['latency_bounded_qps']:.2f} [{card['card']}]")
    _log("[10 summary] serving over meshes whose entries all name this card (virtual shards: "
         "every sharded path, launch and combine; no scaling across cards is shown), rm1 bf16 "
         "batch 512 full size: forward wall ms / device us by mesh, 1x1 (phase 7) "
         f"{times['fwd_wall_ms']:.4f} / {_us(times['fwd_device_ms'])}, "
         + ", ".join(f"{k} {v['wall_ms']:.4f} / {_us(v['device_ms'])}"
                     for k, v in mesh["rm1"].items())
         + f" [{card['card']}]")
    _log("[10 summary]   rm1 one engine, its programs captured, canonical point: "
         + "; ".join(f"{k} mesh QPS {s['measured_qps']:.2f}, p50/p95/p99 {s['p50_ms']:.3f}/"
                     f"{s['p95_ms']:.3f}/{s['p99_ms']:.3f} ms, {s['captures']} graphs in "
                     f"{s['capture_ms']:.1f} ms, pool "
                     + ("not measured" if s["pool_bytes"] is None
                        else f"{s['pool_bytes'] / 2**20:.1f} MiB")
                     + f", peak {s['peak_gib']:.3f} GiB" for k, s in mesh["serving"].items())
         + f" (the eager 2x2 engine: QPS {MESH_EAGER_2X2['measured_qps']:.2f}, p95 "
         f"{MESH_EAGER_2X2['p95_ms']:.3f} ms); reload under traffic 0 failed, "
         f"{mesh_reload_res['apply_ms']:.1f} ms, recapture {mesh_reload_res['recapture_ms']:.1f} "
         f"ms; zoo on 1x4: "
         + ", ".join(f"{r['name']} {r['max_abs_err']:.2e}" for r in mesh_zoo_rows)
         + f" [{card['card']}]")
    _log("[10 summary] training over meshes whose entries all name this card (virtual shards: "
         "every launch, reduction and update; no scaling across cards is shown), f32 batch "
         f"{TRAIN_BATCH} full size, graphed / eager as above")
    for st in mesh_train["steps"]:
        _log(f"[10 summary]   {st['name']}: {_summary_arms(st)} [{card['card']}]")
    for name, r in mesh_train["dedup"].items():
        s, dd = r["sparse"]["graphed"], r["dedup"]["graphed"]
        _log(f"[10 summary]   dedup {name} one device, graphed: step wall ms dedup=False "
             f"{s['wall_ms']:.4f} / True {dd['wall_ms']:.4f}, device "
             f"{_us(s['device_ms'])} / {_us(dd['device_ms'])}, sort + segment "
             f"sum {_us(r['sort_segment_ms'])} [{card['card']}]")
    procs = [r for _, r in sorted(dist_res["results"].items())]
    _log(f"[10 summary] a mesh across {DIST_PROCS} processes ({DIST_LABEL}), rm1 full size, wall "
         f"ms by process: bf16 forward, batch {BATCH}: "
         + "; ".join(f"{k} " + ", ".join(f"{r['fwd'][k]['wall_ms']:.4f}" for r in procs)
                     for k in procs[0]["fwd"])
         + f"; bf16 forward on zipf(1.2) ids, batch {BATCH}: "
         + "; ".join(f"{k} " + ", ".join(f"{r['paths'][k]['wall_ms']:.4f}" for r in procs)
                     for k in procs[0]["paths"])
         + f"; f32 step, batch {TRAIN_BATCH}, {DIST_TRAIN_AXES[0]}x{DIST_TRAIN_AXES[1]}: "
         + "; ".join(f"{m} " + ", ".join(f"{r['train'][m]['wall_ms']:.4f}" for r in procs)
                     for m in procs[0]["train"])
         + f" [{card['card']}]")
    _log(f"[10 summary] processes of a card each over nccl, rm1 full size, batch {TRAIN_BATCH}, "
         "adagrad: path: graphed / eager wall ms a step by process (loss read back), "
         "collectives an eager step, graph pool MiB" + ("" if dist_res["nccl"] else ": not run"))
    for key, rs in dist_res["nccl"].items():
        _log(f"[10 summary]   {key}: "
             + ", ".join(f"{r['wall_ms']['graphed']:.4f}" for r in rs) + " / "
             + ", ".join(f"{r['wall_ms']['eager']:.4f}" for r in rs)
             + f", {rs[0]['collectives']:.1f}, {rs[0]['pool_mib']:.1f} [{card['card']}]")
    soak, ragged, sim = tools["cpu_mp_soak"], tools["ragged_hotcold_soak"], tools["sim_revalidate"]
    sv, scan = sim["results"]["rm1"], tools["refresh_scan_cost"]["results"]["rm1"]
    _log(f"[10 summary] the tools: cpu_mp_soak --accel {soak['minutes']} min {soak['predict_ok']} "
         f"predicts, {soak['n_errors']} errors, "
         f"{sum(c['n_503'] for c in soak['exhaustion_cycles'])} 503s at the wall, "
         f"{soak['slots_leaked_at_quiesce']} leaked, RSS {soak['rss_first_half_mb']:.1f}/"
         f"{soak['rss_second_half_mb']:.1f} MB; ragged_hotcold_soak {ragged['requests_ok']} "
         f"predicts, {ragged['errors']} errors, {ragged['hot_refreshes']} refreshes, p50/p95 "
         f"{ragged['p50_ms']:.3f}/{ragged['p95_ms']:.3f} ms; mesh_bench rm1 ms a forward "
         + ", ".join(f"{k} {v['results']['rm1']['latency_ms']:.4f}"
                     for k, v in tools["mesh_bench"].items())
         + f" (virtual shards of one card); sim_revalidate rm1 p95 real "
         f"{sv['real']['p95_ms']:.3f} / sim {sv['sim']['p95_ms']:.3f} ms "
         f"({sv['p95_rel_err']:+.4f}); refresh_scan_cost rm1 uncapped/capped "
         f"{scan['uncapped_ms']:.1f}/{scan['capped_ms']:.1f} ms [{card['card']}]")
    _log(f"[10 summary] chip_smoke took {time.perf_counter() - t_start:.1f} s after start-up")

    print(card_line())
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "embedding_bag", "route": "cuda", **KERNELS["embedding_bag"],
         "launches": launches["embedding_bag"], "max_abs_err": kernel_errs["embedding_bag"],
         **{k: times["k1"][k] for k in timed}},
        {"name": "rnn_scan", "route": "cuda", **KERNELS["rnn_scan"],
         "launches": launches["rnn_scan"], "max_abs_err": k3_err,
         **{k: k3[k] for k in timed}}] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": trained[key]["max_abs_err"], **{k: trained[key][k] for k in timed}}
        for key in ("embedding_bag_backward", "sparse_adagrad_step", "rnn_scan_backward",
                    "optimizer_update")] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": kernel_errs[key], **{k: quant[mode][k] for k in timed}}
        for key, mode in (("embedding_bag_int8", "int8"),
                          ("embedding_bag_int8_rowwise", "int8_rowwise"))] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": hotcold["errs"][key], **{k: hotcold_t[key][k] for k in timed}}
        for key in HOTCOLD.values()] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": mesh["errs"][key], **{k: mesh["times"]["rm1"][key][k] for k in timed}}
        for key in list(SHARD.values()) + list(HOTCOLD_SHARD.values())] + [
        {"name": key, "route": "cuda", **KERNELS[key], "launches": launches[key],
         "max_abs_err": mesh_train["errs"][key], **{k: mesh_train["times"][key][k] for k in timed}}
        for key in ("embedding_bag_backward_shard", "sparse_adagrad_step_shard")] + [
        # K5's window on a bf16 shard, timed as the graphed steps replay it.
        {"name": "sparse_adagrad_step_shard on a bf16 shard", "route": "cuda",
         **KERNELS["sparse_adagrad_step_shard"], "launches": bf16_launches,
         "max_abs_err": bf16_err,
         **{k: mesh_train["times"]["sparse_adagrad_step_shard bf16"][k] for k in timed}}] + [
        # The new widths' instances, on the paths at those widths (phase 3).
        {"name": f"{key} at {label} = {WINDOW_WIDTH}", "route": "cuda", **KERNELS[key],
         "launches": width_launches[key], "max_abs_err": widths[f"{key} {label}={WINDOW_WIDTH}"],
         **{k: width_t[key][k] for k in timed}}
        for key, label in (("embedding_bag", "d"), ("rnn_scan", "H"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
