"""The PyTorch port imports neither JAX nor anything of the JAX package.

``repro_torch`` keeps its own copies of what it needs (even of JAX-free
modules of ``repro``), and ``chip_smoke.py`` imports only the port,
torch, numpy and the standard library.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "repro"


def test_port_modules_import_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.flat_update.ops" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if "
        "k.split('.')[0].startswith('jax') or "
        "k.split('.')[0] == 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_only_port_torch_numpy_stdlib():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names
    allowed = {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    for name in names:
        assert not _forbidden(name), name
        assert name.split(".")[0] in allowed, name
