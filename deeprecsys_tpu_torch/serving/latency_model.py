"""Latency model of an engine, characterization-driven.

Counterpart of ``deeprecsys_tpu/serving/latency_model.py`` (reference
``accelerator/predict_execution.py``): measured execution times at a ladder
of batch sizes, and a prediction for any batch size by linear
interpolation in log-base space between the two bracketing points
(:67-97). It drives ``SimEngine``, the reference's sleep-based fake
engine.

The card's own ladders, ``gpu_<model>.json`` in ``CHAR_DIR`` (the port's
``characterization/`` directory), are measured by
``python -m deeprecsys_tpu_torch.experiments.sweep``; ``load_card_ladder``
reads one and is the only way ``main.py --engine_backend sim`` and
``experiments/qps_sweep.py`` get a ladder: a sim engine of the port never
runs on another machine's numbers. The command line converts a
reference ``raw_data/results_<model>.txt`` into a ladder file:

    python -m deeprecsys_tpu_torch.serving.latency_model --from-raw results_rm1.txt \\
        --out ladder.json
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

# The card's latency ladders, one gpu_<model>.json a model.
CHAR_DIR = Path(__file__).resolve().parents[1] / "characterization"


class LatencyModel:
    """Piecewise log-linear latency vs. batch-size model."""

    def __init__(self, batch_sizes, latencies_ms, base: float = 4.0):
        if len(batch_sizes) != len(latencies_ms):
            raise ValueError(
                f"{len(batch_sizes)} batch sizes vs {len(latencies_ms)} "
                f"latencies — a mismatched ladder would silently drop or "
                f"misalign measurements")
        order = np.argsort(batch_sizes)
        self.batches = np.asarray(batch_sizes, dtype=np.float64)[order]
        self.lat_ms = np.asarray(latencies_ms, dtype=np.float64)[order]
        self.base = float(base)
        if len(self.batches) < 1:
            raise ValueError("need at least one measurement")

    def predict_ms(self, batch_size: int) -> float:
        """Latency for ``batch_size``, interpolated in log-space: an exact
        hit returns the measurement; below the smallest point the model
        clamps to it, above the largest it extrapolates with the last
        segment's slope."""
        b = float(batch_size)
        if b <= self.batches[0]:
            # Clamp before any log: b can be 0 (an empty request probe).
            return float(self.lat_ms[0])
        logb = math.log(b, self.base)
        logs = np.log(self.batches) / math.log(self.base)
        if b >= self.batches[-1]:
            if len(self.batches) == 1:
                return float(self.lat_ms[-1])
            slope = (self.lat_ms[-1] - self.lat_ms[-2]) / (logs[-1] - logs[-2])
            return float(self.lat_ms[-1] + slope * (logb - logs[-1]))
        j = int(np.searchsorted(self.batches, b, side="right")) - 1
        frac = (logb - logs[j]) / (logs[j + 1] - logs[j])
        return float(self.lat_ms[j] + frac * (self.lat_ms[j + 1] - self.lat_ms[j]))

    def with_overhead(self, a_ms: float, ms_per_sample: float) -> "LatencyModel":
        """A model predicting ``interp(b) + a_ms + ms_per_sample*b``: a
        per-dispatch transport cost affine in the payload, added after the
        interpolation."""
        return _OverheadModel(self, float(a_ms), float(ms_per_sample))

    def with_overlap(self, a_ms: float, ms_per_sample: float) -> "LatencyModel":
        """A model predicting ``max(interp(b), ms_per_sample*b) + a_ms``:
        transfer overlapped with compute by the engine's pipeline, plus the
        dispatch floor."""
        return _OverlapModel(self, float(a_ms), float(ms_per_sample))

    @classmethod
    def from_reference_raw(cls, path: str | Path, base: float = 4.0) -> "LatencyModel":
        """Ingest a reference ``raw_data/results_<model>.txt``: six ``***``
        timing lines a batch point (``inferenceEngine.py:168-173``), the
        points at batch ``base**i``; column 5 of each 6-tuple, execution ms
        an iteration, is the ladder point (``predict_execution.py:10-29``)."""
        values = []
        for line in Path(path).read_text().splitlines():
            if "***" not in line:
                continue
            tail = line[line.rindex("*") + 1:]
            if "ms" not in tail:
                raise ValueError(f"malformed *** line (no 'ms'): {line!r}")
            values.append(float(tail[: tail.rindex("ms")]))
        if not values or len(values) % 6:
            raise ValueError(
                f"{path}: expected groups of six '***' timing lines per "
                f"batch point (got {len(values)} values) — is this a "
                f"reference results_<model>.txt?")
        exec_ms_per_iter = values[5::6]
        batches = [base ** i for i in range(len(exec_ms_per_iter))]
        return cls(batches, exec_ms_per_iter, base=base)

    def to_json(self) -> dict:
        return {"batch_sizes": self.batches.tolist(), "latencies_ms": self.lat_ms.tolist(),
                "base": self.base}

    @classmethod
    def from_json(cls, d: dict) -> "LatencyModel":
        m = cls(d["batch_sizes"], d["latencies_ms"], d.get("base", 4.0))
        if d.get("overhead"):  # calibrated transport term round-trips
            o = d["overhead"]
            if o.get("overlap"):
                return m.with_overlap(o["a_ms"], o["ms_per_sample"])
            return m.with_overhead(o["a_ms"], o["ms_per_sample"])
        return m

    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(self.to_json()))

    @classmethod
    def load(cls, path: str | Path) -> "LatencyModel":
        return cls.from_json(json.loads(Path(path).read_text()))


class _OverheadModel(LatencyModel):
    """LatencyModel plus an affine per-dispatch transport term."""

    def __init__(self, base_model: LatencyModel, a_ms: float, ms_per_sample: float):
        super().__init__(base_model.batches, base_model.lat_ms, base=base_model.base)
        self.a_ms = a_ms
        self.ms_per_sample = ms_per_sample

    def predict_ms(self, batch_size: int) -> float:
        return (super().predict_ms(batch_size)
                + self.a_ms + self.ms_per_sample * float(batch_size))

    def to_json(self) -> dict:
        d = super().to_json()
        d["overhead"] = {"a_ms": self.a_ms, "ms_per_sample": self.ms_per_sample}
        return d


class _OverlapModel(LatencyModel):
    """LatencyModel where transfer overlaps compute: max(compute, transfer)
    + dispatch floor."""

    def __init__(self, base_model: LatencyModel, a_ms: float, ms_per_sample: float):
        super().__init__(base_model.batches, base_model.lat_ms, base=base_model.base)
        self.a_ms = a_ms
        self.ms_per_sample = ms_per_sample

    def predict_ms(self, batch_size: int) -> float:
        compute = super().predict_ms(batch_size)
        transfer = self.ms_per_sample * float(batch_size)
        return max(compute, transfer) + self.a_ms

    def to_json(self) -> dict:
        d = super().to_json()
        d["overhead"] = {"a_ms": self.a_ms, "ms_per_sample": self.ms_per_sample,
                         "overlap": True}
        return d


def card_ladder_path(model_name: str) -> Path:
    """Where ``experiments/sweep.py`` writes ``model_name``'s ladder."""
    return CHAR_DIR / f"gpu_{model_name}.json"


def load_card_ladder(model_name: str) -> tuple[LatencyModel, dict]:
    """The ladder measured on the card for ``model_name`` and the file's
    fields (``device``, ``power_limit``, ``dtype``, ``table_scale``, ...).
    Raises FileNotFoundError when it was never measured: no other file
    (the JAX package's ``tpu_*`` or ``cpu_*`` ladders) stands in."""
    path = card_ladder_path(model_name)
    if not path.exists():
        raise FileNotFoundError(
            f"engine_backend sim needs the card's latency ladder {path}; measure it "
            f"on the card with `python -m deeprecsys_tpu_torch.experiments.sweep "
            f"--models {model_name}` (experiments/sweep.py)")
    fields = json.loads(path.read_text())
    return LatencyModel.from_json(fields), fields


def main(argv=None):
    """Convert a reference ``raw_data/results_<model>.txt`` (the ``***``
    6-tuple format) into a ladder JSON that ``LatencyModel.load`` reads."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--from-raw", required=True, help="reference results_<model>.txt path")
    ap.add_argument("--out", required=True, help="output JSON path")
    ap.add_argument("--base", type=float, default=4.0,
                    help="batch ladder base (4 = GTX-1080Ti sweeps, 2 = GTX-960)")
    args = ap.parse_args(argv)
    m = LatencyModel.from_reference_raw(args.from_raw, base=args.base)
    m.save(args.out)
    print(f"wrote {args.out}: batches {m.batches.astype(int).tolist()}, "
          f"exec ms/iter {[round(v, 4) for v in m.lat_ms.tolist()]}")


if __name__ == "__main__":
    main()
