"""A trainer's step programs, one a batch shape: the counterpart of the JAX
trainer's ``jax.jit(step, donate_argnums=(0, 1))``
(``deeprecsys_tpu/train.py:207`` sharded sparse, ``:346-349`` sparse,
``:366-367`` dense, ``:392-397`` dense over a mesh), built as
``serving/programs.py`` builds an engine's.

JAX compiles a training step once a batch shape and runs that program for
every later batch of the shape. Here, on a card, the first step of a shape
runs eagerly: that is the real step, and it builds the kernels, fills the
wrappers' host caches and creates cuBLAS's workspace on the trainer's
stream, none of which a capture may do. The step is then captured as a CUDA
graph. A capture launches nothing, so the params are not updated twice.
Every later step of the shape copies the host batch into the program's
static inputs (``non_blocking``, from pinned memory) and replays the graph:
one call into PyTorch where the eager step makes hundreds of launches from
Python. The loss comes back in a tensor of its own, which later replays do
not overwrite; ``float(loss)`` waits for its step, as JAX's ``float(loss)``
does (``deeprecsys_tpu/train.py:427``).

- ``StepInputs``: the device buffers a program reads (``dense``,
  ``indices``, ``mask``, ``targets``) at its batch shape.
- ``StepProgram``: one shape's program: its inputs and, on a card, its
  graph, its static loss and the kernel launches its capture recorded,
  which each replay adds to the wrappers' counters (``_build.count_replay``).
- ``StepPrograms``: a trainer's programs by shape and the stream they run
  on; on a card they share one graph memory pool, which is safe because
  the stream runs their replays one after another.

On the CPU, which the tests ask for, a program runs the step eagerly over
the same static buffers, so the CPU tests reach the copy-in and the shape
keys. A capture that fails raises: nothing falls back to the eager step.
Captures use ``capture_error_mode="thread_local"`` (autograd's worker thread
launches the backward onto the captured stream, and ``_build`` tallies its
launches by that stream) and hold the serving engines' ``BUILD_LOCK``, so a
trainer never captures while an engine of the same process builds.

A program closes over the tensors it was captured with. Whatever replaces
the trainer's params or optimizer state, instead of writing into them,
drops the programs (``reset``). Which steps stay eager is decided when the
trainer is built (``eager_reason``), never by catching a failed capture.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.serving.programs import (
    BUILD_LOCK, capture, pool_bytes, eager_reason as mesh_eager_reason)

StepFn = Callable[[Batch, torch.Tensor], torch.Tensor]  # (batch, targets) -> loss


def eager_reason(mesh, table_dtype: torch.dtype | None = None, sparse: bool = False):
    """Why a trainer's steps stay eager, or None where they are captured:
    on one device, and on a mesh of one process whose entries all name one
    device (one card's virtual shards, ``["cuda:0"] * 4``). A mesh across
    processes takes the engines' reason (``serving/programs.py::
    eager_reason``); a mesh over several cards its own. ``table_dtype`` and
    ``sparse``: the table's dtype and whether the mesh step updates it by
    K5's window."""
    reason = mesh_eager_reason(mesh)
    if reason is not None or mesh is None:
        return reason
    if len(mesh.distinct_devices) > 1:
        return ("a trainer over several cards: its backward runs on autograd's worker "
                "thread of each card, so a card's share of a step is launched from several "
                "threads, which a capture a card would have to take in; captures across "
                "cards are not tried for the trainers")
    if sparse and table_dtype is not None and table_dtype != torch.float32:
        return ("K5's window on a bf16 shard keeps its count and hash keys from call to "
                "call, and each call zeroes the next call's count, which a replay would "
                "skip (ops/sparse_adagrad.py::sparse_adagrad_step_shard refuses a capture)")
    return None


def step_key(host: Batch, targets: torch.Tensor) -> tuple:
    """A batch's program key: each field's shape and dtype (None where the
    batch has no such field), the targets' last."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in (*host, targets))


class StepInputs:
    """Device buffers of one batch shape: ``batch`` (a ``Batch`` of them)
    and ``targets``."""

    def __init__(self, host: Batch, targets: torch.Tensor, device: torch.device):
        def buf(x):
            return None if x is None else torch.empty(x.shape, dtype=x.dtype, device=device)

        self.batch = Batch(*(buf(x) for x in host))
        self.targets = buf(targets)

    def load(self, host: Batch, targets: torch.Tensor):
        """Copy a step's host batch (pinned on a card) into the buffers, on
        the current stream."""
        on_card = self.targets.device.type == "cuda"
        for dst, src in zip((*self.batch, self.targets), (*host, targets)):
            if dst is not None:
                dst.copy_(src, non_blocking=on_card)


class StepProgram:
    """One batch shape's step: ``step(inputs.batch, inputs.targets)``,
    captured as a graph on a card."""

    def __init__(self, key: tuple, step: StepFn, inputs: StepInputs, device: torch.device):
        self.key = key
        self.step = step
        self.inputs = inputs
        self.device = device
        self.graph = None
        self.loss = None          # the graph's static loss (a card)
        self.launches: dict = {}  # wrapper -> launches a replay (a card)
        self.capture_ms = 0.0
        self.runs = 0             # steps taken, the eager first one included

    def run(self, host: Batch, targets: torch.Tensor) -> torch.Tensor:
        """One step: copy the batch in, then replay (a card; the loss
        copied out of the graph) or run the step (the CPU)."""
        self.runs += 1
        self.inputs.load(host, targets)
        if self.graph is None:
            return self.step(self.inputs.batch, self.inputs.targets)
        self.graph.replay()
        _build.count_replay(self.launches)
        return self.loss.clone()

    def build(self, host: Batch, targets: torch.Tensor, pool, stream) -> torch.Tensor:
        """The shape's first step, eagerly, then its capture into ``pool`` on
        ``stream`` (the current one). Returns the eager step's loss."""
        loss = self.run(host, targets)
        self.graph, self.loss, self.launches, self.capture_ms = capture(
            lambda: self.step(self.inputs.batch, self.inputs.targets), pool, stream)
        return loss


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A host tensor in pinned memory (a non_blocking copy from it is
    asynchronous); a tensor on a card as it is."""
    if x is None or x.device.type != "cpu" or x.is_pinned():
        return x
    return x.contiguous().pin_memory()


class StepPrograms:
    """A trainer's step programs by batch shape (``step_key``).

    ``programs(host, targets)`` takes one step: ``host`` a ``Batch`` of host
    arrays or tensors, ``targets`` a tensor; returns the loss, a scalar
    tensor on the device (not synchronised). On a card the steps run on the
    programs' own stream (``stream``), ordered after the caller's current
    stream's work and before its later work."""

    def __init__(self, step: StepFn, device: torch.device):
        self.step = step
        self.device = device
        on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if on_card else None
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.programs: dict[tuple, StepProgram] = {}
        self.captures = 0
        self.capture_ms = 0.0

    @contextlib.contextmanager
    def on_stream(self):
        """Run the body on the programs' stream (a card), after the caller's
        stream's work and before its later work; on the CPU as it is."""
        if self.stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def __call__(self, host: Batch, targets) -> torch.Tensor:
        host = Batch(*(None if x is None else torch.as_tensor(x) for x in host))
        targets = torch.as_tensor(targets)
        key = step_key(host, targets)
        prog = self.programs.get(key)
        if self.stream is None:
            if prog is None:
                prog = self.programs[key] = StepProgram(
                    key, self.step, StepInputs(host, targets, self.device), self.device)
            return prog.run(host, targets)
        with self.on_stream():
            host, targets = Batch(*(_pinned(x) for x in host)), _pinned(targets)
            if prog is None:
                prog = StepProgram(key, self.step, StepInputs(host, targets, self.device),
                                   self.device)
                with BUILD_LOCK:
                    loss = prog.build(host, targets, self.pool, self.stream)
                self.programs[key] = prog
                self.captures += 1
                self.capture_ms += prog.capture_ms
            else:
                loss = prog.run(host, targets)
        loss.record_stream(torch.cuda.current_stream(self.device))
        return loss

    def reset(self):
        """Drop every program (the params or state they were captured with
        were replaced); the next step of each shape builds anew. The pool
        is freed once the stream has run the replays already queued."""
        if self.stream is not None and self.programs:
            self.stream.synchronize()
            self.pool = torch.cuda.graph_pool_handle()
        self.programs = {}

    def pool_bytes(self):
        """Device bytes the programs' graph pool holds; None on the CPU."""
        return pool_bytes(self.pool)
