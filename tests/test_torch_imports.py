"""The port and chip_smoke.py load with JAX made unimportable, and
chip_smoke.py names no module of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "deeprecsys_tpu_torch",
    "deeprecsys_tpu_torch.zoo",
    "deeprecsys_tpu_torch.bridge",
    "deeprecsys_tpu_torch.main",
    "deeprecsys_tpu_torch.data",
    "deeprecsys_tpu_torch.data.generator",
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
    "deeprecsys_tpu_torch.ops.rnn",
    "deeprecsys_tpu_torch.serving",
    "deeprecsys_tpu_torch.utils.devices",
    "chip_smoke",
]


def test_port_imports_without_jax(tmp_path):
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"  # any `import jax` now raises
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert sys.modules['jax'] is None\n"
            "print('ok')\n")
    env = dict(os.environ, DRS_NATIVE_CACHE=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the shared config and serving modules through
    the port, never by naming ``deeprecsys_tpu`` or jax itself."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "deeprecsys_tpu_torch" in roots
    assert not roots & {"deeprecsys_tpu", "jax", "jaxlib"}, sorted(names)
