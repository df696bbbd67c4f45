"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the rank
processes of the collective tests (``tests/_torch_ranks.py``) import no
``jax`` and nothing of the JAX package ``repro``.

Checked on the source with ``ast`` (every import statement of every file),
and once by importing the whole port in a fresh interpreter.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the collective tests' rank processes re-import this helper when spawned
PORT_FILES += [ROOT / "tests" / "_torch_ranks.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            bad += [a.value for a in node.args[:1]
                    if isinstance(a, ast.Constant) and _forbidden(str(a.value))]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_source_check_covers_every_model_family_module():
    """The ported families' modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("attention", "frontend", "layers", "moe", "ssm", "transformer", "xlstm"):
        assert f"src/repro_torch/models/{mod}.py" in names


def test_the_source_check_covers_the_training_modules():
    """The training slice's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("train/optimizer", "train/train_step", "data/pipeline", "checkpoint/checkpoint",
                "runtime/elastic", "launch/train"):
        assert f"src/repro_torch/{mod}.py" in names


def test_the_source_check_covers_the_scale_out_modules():
    """The collectives slice's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("launch/mesh", "core/com", "parallel/collectives", "parallel/pipeline",
                "parallel/sharding", "parallel/shard_sweep", "train/grad_compress",
                "runtime/elastic", "checkpoint/checkpoint"):
        assert f"src/repro_torch/{mod}.py" in names
    assert "tests/_torch_ranks.py" in names


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import _torch_ranks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                                        str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
