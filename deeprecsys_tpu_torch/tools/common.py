"""What the tools share: the device they run on, the card's name beside
every number, and where their records go."""

from __future__ import annotations

import json
import resource
from pathlib import Path

import torch

from deeprecsys_tpu_torch.kernel_bench import card_line


OUT_DIR = Path(__file__).resolve().parents[2] / "chiprun_out" / "tools"


def default_out(name: str) -> Path:
    return OUT_DIR / f"{name}.json"


def device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(utils/devices.py::resolve_device)")


def card_of(device: torch.device) -> str:
    """The card's ``name, power.limit`` as nvidia-smi gives them, or
    ``"host CPU"`` for a CPU run."""
    return card_line() if device.type == "cuda" else "host CPU"


def write_record(path, record: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2))
    return path


def max_rss_mb() -> float:
    """This process's peak resident set, MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mb() -> float:
    """This process's resident set now, MB."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 1e6
