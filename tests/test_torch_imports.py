"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``
or the port's examples) imports ``jax`` or the JAX package ``repro``, and
the package imports with both blocked.  Its storage layer does not load ``torch`` either, so the I/O
engine's process-pool workers stay light."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
BLOCKED = ("jax", "jaxlib", "repro")

_BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)


def test_port_imports_with_jax_and_repro_blocked():
    pytest.importorskip("torch")
    r = _run(_BLOCKER.format(blocked=BLOCKED) + """
import repro_torch, repro_torch.checkpoint, repro_torch.kernels.ops
import repro_torch.data, repro_torch.repair
import repro_torch.configs, repro_torch.models, repro_torch.parallel
import repro_torch.models.moe, repro_torch.models.ssm
import repro_torch.serve, repro_torch.launch.serve
import repro_torch.train, repro_torch.launch.train
import repro_torch.io.merger, repro_torch.tune
import repro_torch.parallel.sharding, repro_torch.parallel.meshed, repro_torch.launch.mesh
import repro_torch.launch.specs, repro_torch.launch.hlo_cost
import repro_torch.launch.dryrun
import repro_torch.remote, repro_torch.remote.__main__, repro_torch.fault
import repro_torch.obs.heat, repro_torch.obs.slo, repro_torch.obs.__main__
import repro_torch.repair.scrub, repro_torch.repair.reconcile
repro_torch.configs.get_config("rwkv6-1.6b")
assert not any(m.split(".")[0] in {blocked!r} for m in sys.modules), \\
    sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r})
""".format(blocked=BLOCKED))
    assert r.returncode == 0, r.stderr


def test_storage_layer_does_not_load_torch():
    r = _run("""
import sys
import repro_torch, repro_torch.core, repro_torch.io.engine, repro_torch.obs
import repro_torch.io, repro_torch.io.prefetch
import repro_torch.data, repro_torch.data.pipeline
import repro_torch.io.merger, repro_torch.tune
import repro_torch.remote, repro_torch.remote.__main__, repro_torch.fault
import repro_torch.obs.heat, repro_torch.obs.slo, repro_torch.obs.__main__
import repro_torch.repair, repro_torch.repair.scrub, repro_torch.repair.reconcile
assert "torch" not in sys.modules
""")
    assert r.returncode == 0, r.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return (sorted((SRC / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    # whole module names: "repro_torch" starts with "repro" but is not it
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
