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
- ``StagedStep``: one shape's step over several cards of one process
  (``TrainCut``, ``parallel/sharding.py::mesh_train_stages``): static
  inputs on each card, the step's parts, each captured as a graph on its
  card's stream into its card's pool, and the tensors that cross cards
  copied between the replays into receive buffers on the receiving card
  (``serving/programs.py::StagedProgram``, the mesh engines' loop). Each
  part touches one card, so autograd's worker thread of that card
  launches a row part's backward onto that card's captured stream.
- ``StepPrograms``: a trainer's programs by shape and the streams they
  run on (one a card); on a card they share one graph memory pool a card,
  which is safe because each stream runs their replays one after another.

On the CPU, which the tests ask for, a program runs the step (or its
parts, with their sends) eagerly over the same static buffers, so the CPU
tests reach the copy-in, the shape keys and the cut. A capture that fails
raises: nothing falls back to the eager step.
Captures use ``capture_error_mode="thread_local"`` (autograd's worker thread
launches the backward onto the captured stream, and ``_build`` tallies its
launches by that stream) and hold the serving engines' ``BUILD_LOCK``, so a
trainer never captures while an engine of the same process builds.

Across processes over nccl, each process holding one card, a program is
that process's step with its collectives: every process builds the same
programs in the same order, since each decides from the batch shape alone,
and a shape's first, eager step makes every group's communicator before
any capture. NCCL launches its kernels onto a stream of its own, ordered
after and before the captured stream by events, which the graph records;
torch.distributed keeps a captured collective out of its watchdog. Such a
step replays slower than it runs eagerly (``NCCL_SLOWER``), so a trainer
takes these programs only when asked (``Trainer.take_programs``).

A program closes over the tensors it was captured with. Whatever replaces
the trainer's params or optimizer state, instead of writing into them,
drops the programs (``reset``). Which steps stay eager is decided when the
trainer is built (``eager_reason``: a mesh across processes over gloo, or
one whose process holds several cards, which cannot be captured, and one
over nccl, whose graphs replay slower), never by catching a failed
capture, and so is whether a mesh takes one program or parts
(``train_cut``: more than one place of one process means parts).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.serving.programs import (
    BUILD_LOCK, StagedProgram, capture, pool_bytes_by_card, eager_reason as mesh_eager_reason)

StepFn = Callable[[Batch, torch.Tensor], torch.Tensor]  # (batch, targets) -> loss


def capture_reason(mesh):
    """Why a trainer's step over ``mesh`` cannot be captured, or None where
    it can: on one device and on any mesh of one process (one program where
    its entries all name one card, a graph a part over several cards), and
    on a mesh across processes over nccl whose process holds one card (one
    program a process: its NCCL collectives are captured with the step).
    Across processes over gloo the collectives go through host copies,
    which a graph cannot hold; a process that holds several cards would
    need its step cut by card around collectives that all run on its first
    card (``Mesh._staged``), which the cut has no part for."""
    if mesh is None or not mesh.multi_process:
        return None
    if mesh.backend != "nccl":
        return mesh_eager_reason(mesh)  # the engines' gloo reason
    if len(mesh.distinct_devices) > 1:
        return ("a mesh across processes whose process holds several cards: its step would "
                "be cut into a graph a card, and its collectives all run on its first card "
                "(Mesh._staged), for which the cut has no part")
    return None


NCCL_SLOWER = (
    "a mesh across processes over nccl, a card each: its step, captured as one graph a "
    "process, replayed 2-8x slower than its eager step on four H100s (rm1, batch 128: sparse "
    "1x4 29.9-33.4 ms a step against 4.2-4.3, dense 2x2 43.0-44.2 against 17.7; "
    "experiments/nccl_step_probe.py, the processes meeting at a barrier before each turn), "
    "the time spent inside NCCL's all-reduce kernels in the graph and the card otherwise "
    "idle; so it runs eagerly until a traced fix makes the replay no slower "
    "(Trainer.take_programs captures it, to measure it)")


def eager_reason(mesh):
    """Why a trainer's steps stay eager, or None where they are captured:
    ``capture_reason``'s, and across processes over nccl, where each
    process's step can be captured, the measured slowdown ``NCCL_SLOWER``."""
    reason = capture_reason(mesh)
    if reason is None and mesh is not None and mesh.multi_process:
        return NCCL_SLOWER
    return reason


class TrainCut(NamedTuple):
    """A mesh step cut into parts by place (``parallel/sharding.py::
    train_places``): ``stages(inputs, places)`` makes one batch shape's
    parts over the static inputs of each place (``inputs[place]``, a dict
    by name)."""

    places: object
    stages: Callable


def train_cut(mesh, stages: Callable) -> TrainCut | None:
    """The cut of a step over ``mesh`` (``stages`` as ``TrainCut``'s), or
    None where the mesh's entries are all one place, and across processes
    (each process's one card, ``eager_reason``): one program."""
    from deeprecsys_tpu_torch.parallel.sharding import train_places

    if mesh.multi_process:
        return None
    places = train_places(mesh)
    return TrainCut(places, stages) if len(places.devices) > 1 else None


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

    def named(self) -> dict:
        """The buffers by name: the batch's fields and ``targets``."""
        return {**self.batch._asdict(), "targets": self.targets}

    def load(self, host: Batch, targets: torch.Tensor):
        """Copy a step's host batch (pinned on a card) into the buffers, on
        the current stream of their card."""
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

    def build(self, host: Batch, targets: torch.Tensor, pools: dict) -> torch.Tensor:
        """The shape's first step, eagerly, then its capture into its card's
        pool (``pools`` by device) on the card's current stream. Returns the
        eager step's loss."""
        loss = self.run(host, targets)
        self.graph, self.loss, self.launches, self.capture_ms = capture(
            lambda: self.step(self.inputs.batch, self.inputs.targets), pools[self.device],
            torch.cuda.current_stream(self.device))
        return loss


class StagedStep(StagedProgram):
    """One batch shape's step over several places (``TrainCut``): static
    inputs a place, the step's parts over them (each captured as a graph on
    its card), the tensors that cross places copied between the parts
    (``serving/programs.py::StagedProgram``)."""

    def __init__(self, key: tuple, cut: TrainCut, host: Batch, targets: torch.Tensor):
        self.inputs = {p: StepInputs(host, targets, dev) for p, dev in cut.places.devices.items()}
        super().__init__(cut.stages({p: x.named() for p, x in self.inputs.items()}, cut.places))
        self.key = key
        self.runs = 0  # steps taken, the eager first one included

    def run(self, host: Batch, targets: torch.Tensor) -> torch.Tensor:
        """One step: copy the batch into every place's inputs, then replay
        the parts (a card; the loss copied out of its graph) or run them."""
        self.runs += 1
        for x in self.inputs.values():
            x.load(host, targets)
        if not self.graphs:
            return self._eager()
        return self._replay().clone()

    def build(self, host: Batch, targets: torch.Tensor, pools: dict) -> torch.Tensor:
        """The shape's first step, its parts run eagerly, then each part
        captured into its card's pool on the card's current stream. Returns
        the eager step's loss."""
        loss = self.run(host, targets)
        self._capture(pools)
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
    tensor on ``device`` (not synchronised). ``step`` is the step function
    itself; with ``cut`` (a step over several places) a program is the
    step's parts instead (``StagedStep``). On a card the steps run on the
    programs' own stream on each card (``streams``), ordered after each
    caller's current stream's work and before its later work."""

    def __init__(self, step: StepFn, device: torch.device, cut: TrainCut | None = None):
        self.step = step
        self.device = device
        self.cut = cut
        devices = [device] if cut is None else list(dict.fromkeys(cut.places.devices.values()))
        on_card = device.type == "cuda"
        # The home card's last, so that it is the current card inside on_stream.
        devices = sorted(devices, key=lambda dev: dev == device)
        self.streams = {dev: torch.cuda.Stream(dev) for dev in devices} if on_card else {}
        self.pools = {dev: torch.cuda.graph_pool_handle() for dev in devices} if on_card else {}
        self.programs: dict = {}
        self.captures = 0
        self.capture_ms = 0.0

    @contextlib.contextmanager
    def on_stream(self):
        """Run the body on the programs' streams (a card), each after its
        card's caller's stream's work and before its later work, the
        caller's stream on ``device`` after all of them (so that reading
        the loss waits for the whole step); on the CPU as it is."""
        if not self.streams:
            yield
            return
        callers = {dev: torch.cuda.current_stream(dev) for dev in self.streams}
        with contextlib.ExitStack() as stack:
            for dev, stream in self.streams.items():
                stream.wait_stream(callers[dev])
                stack.enter_context(torch.cuda.stream(stream))
            yield
        for dev, stream in self.streams.items():
            callers[dev].wait_stream(stream)
            if dev != self.device:
                callers[self.device].wait_stream(stream)

    def _program(self, key: tuple, host: Batch, targets: torch.Tensor):
        if self.cut is not None:
            return StagedStep(key, self.cut, host, targets)
        return StepProgram(key, self.step, StepInputs(host, targets, self.device), self.device)

    def __call__(self, host: Batch, targets) -> torch.Tensor:
        host = Batch(*(None if x is None else torch.as_tensor(x) for x in host))
        targets = torch.as_tensor(targets)
        key = step_key(host, targets)
        prog = self.programs.get(key)
        if not self.streams:
            if prog is None:
                prog = self.programs[key] = self._program(key, host, targets)
            return prog.run(host, targets)
        with self.on_stream():
            host, targets = Batch(*(_pinned(x) for x in host)), _pinned(targets)
            if prog is None:
                prog = self._program(key, host, targets)
                with BUILD_LOCK:
                    loss = prog.build(host, targets, self.pools)
                self.programs[key] = prog
                self.captures += 1
                self.capture_ms += prog.capture_ms
            else:
                loss = prog.run(host, targets)
        loss.record_stream(torch.cuda.current_stream(self.device))
        return loss

    def reset(self):
        """Drop every program (the params or state they were captured with
        were replaced); the next step of each shape builds anew. The pools
        are freed once the streams have run the replays already queued."""
        if self.streams and self.programs:
            for stream in self.streams.values():
                stream.synchronize()
            self.pools = {dev: torch.cuda.graph_pool_handle() for dev in self.streams}
        self.programs = {}

    def pool_bytes_by_card(self) -> dict:
        """Device bytes the programs' graph pools hold, by card index; empty
        on the CPU."""
        return pool_bytes_by_card(self.pools.values()) if self.pools else {}

    def pool_bytes(self):
        """Device bytes the programs' graph pools hold; None on the CPU."""
        return sum(self.pool_bytes_by_card().values()) if self.pools else None
