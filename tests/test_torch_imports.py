"""The port and chip_smoke.py import nothing of JAX or of the JAX package:
an AST walk of every module, and an import with JAX made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "deeprecsys_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"deeprecsys_tpu", "jax", "jaxlib"}

MODULES = [
    "deeprecsys_tpu_torch",
    "deeprecsys_tpu_torch.config",
    "deeprecsys_tpu_torch.zoo",
    "deeprecsys_tpu_torch.bridge",
    "deeprecsys_tpu_torch.main",
    "deeprecsys_tpu_torch.kernel_bench",
    "deeprecsys_tpu_torch.engine_bench",
    "deeprecsys_tpu_torch.experiments",
    "deeprecsys_tpu_torch.experiments.skew_bench",
    "deeprecsys_tpu_torch.experiments.sweep",
    "deeprecsys_tpu_torch.experiments.op_breakdown",
    "deeprecsys_tpu_torch.experiments.qps_sweep",
    "deeprecsys_tpu_torch.experiments.scheduling_study",
    "deeprecsys_tpu_torch.experiments.loadgen_study",
    "deeprecsys_tpu_torch.experiments.train_quality",
    "deeprecsys_tpu_torch.experiments.plots",
    "deeprecsys_tpu_torch.experiments.int8_sweep",
    "deeprecsys_tpu_torch.experiments.k3b_sweep",
    "deeprecsys_tpu_torch.experiments.k5_sweep",
    "deeprecsys_tpu_torch.experiments.k6_sweep",
    "deeprecsys_tpu_torch.experiments.sweep_build",
    "deeprecsys_tpu_torch.runtime",
    "deeprecsys_tpu_torch.runtime.native",
    "deeprecsys_tpu_torch.runtime.shm_queue",
    "deeprecsys_tpu_torch.runtime.blob_arena",
    "deeprecsys_tpu_torch.utils.memory",
    "deeprecsys_tpu_torch.models.hotcold",
    "deeprecsys_tpu_torch.ops.hotcold",
    "deeprecsys_tpu_torch.data",
    "deeprecsys_tpu_torch.data.generator",
    "deeprecsys_tpu_torch.data.criteo",
    "deeprecsys_tpu_torch.data.trace",
    "deeprecsys_tpu_torch.data.ragged",
    "deeprecsys_tpu_torch.models",
    "deeprecsys_tpu_torch.models.base",
    "deeprecsys_tpu_torch.models.dlrm",
    "deeprecsys_tpu_torch.models.wide_and_deep",
    "deeprecsys_tpu_torch.models.multi_task_wnd",
    "deeprecsys_tpu_torch.models.ncf",
    "deeprecsys_tpu_torch.models.din",
    "deeprecsys_tpu_torch.models.dien",
    "deeprecsys_tpu_torch.ops",
    "deeprecsys_tpu_torch.ops._build",
    "deeprecsys_tpu_torch.ops.embedding",
    "deeprecsys_tpu_torch.ops.interactions",
    "deeprecsys_tpu_torch.ops.mlp",
    "deeprecsys_tpu_torch.ops.optimizer",
    "deeprecsys_tpu_torch.ops.rnn",
    "deeprecsys_tpu_torch.ops.sparse_adagrad",
    "deeprecsys_tpu_torch.parallel",
    "deeprecsys_tpu_torch.parallel.sharding",
    "deeprecsys_tpu_torch.parallel.mesh",
    "deeprecsys_tpu_torch.parallel.placement",
    "deeprecsys_tpu_torch.parallel.api",
    "deeprecsys_tpu_torch.serving",
    "deeprecsys_tpu_torch.serving.buckets",
    "deeprecsys_tpu_torch.serving.engine",
    "deeprecsys_tpu_torch.serving.ingress",
    "deeprecsys_tpu_torch.serving.process_engine",
    "deeprecsys_tpu_torch.serving.latency_model",
    "deeprecsys_tpu_torch.serving.load_generator",
    "deeprecsys_tpu_torch.serving.metrics",
    "deeprecsys_tpu_torch.serving.orchestrator",
    "deeprecsys_tpu_torch.serving.packets",
    "deeprecsys_tpu_torch.serving.scheduler",
    "deeprecsys_tpu_torch.utils.checkpoint",
    "deeprecsys_tpu_torch.utils.devices",
    "deeprecsys_tpu_torch.utils.metrics_ml",
    "deeprecsys_tpu_torch.train",
    "chip_smoke",
]


def _imported_roots(path: Path) -> set:
    """The top-level package of every import statement in ``path``,
    function-local ones included (relative imports count as the port's)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add("deeprecsys_tpu_torch" if node.level else node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN, sorted(_imported_roots(path))


def test_chip_smoke_imports_only_the_port():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "deeprecsys_tpu_torch" in roots and not roots & FORBIDDEN, sorted(roots)
    # Every module the import test loads is one the AST walk reads.
    walked = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in SOURCES}
    assert {m.removesuffix(".__init__") for m in walked} >= set(MODULES)


def test_port_imports_without_jax():
    """Every module loads with jax unimportable, and afterwards no module of
    the JAX package is loaded (so nothing built its native pacer either)."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"  # any `import jax` now raises
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert sys.modules['jax'] is None\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'deeprecsys_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
