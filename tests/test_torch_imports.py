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


# the threaded cluster's slice: obs, cluster, the legacy dana_update
# kernel, the shared kernel loader and the cluster CLI
NEW_IN_SLICE_2 = (
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.cluster", "repro_torch.cluster.clock",
    "repro_torch.cluster.faults", "repro_torch.cluster.mailbox",
    "repro_torch.cluster.master", "repro_torch.cluster.worker",
    "repro_torch.cluster.runtime", "repro_torch.kernels._build",
    "repro_torch.kernels.dana_update", "repro_torch.kernels.dana_update.ref",
    "repro_torch.kernels.dana_update.kernel",
    "repro_torch.kernels.dana_update.ops", "repro_torch.launch",
    "repro_torch.launch.cluster")

# falcon-mamba serving: configs, the LM stack, the serve steps and CLI,
# the continuous-batching engine and the selective-scan kernel
NEW_IN_SLICE_4 = (
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.chatglm3_6b", "repro_torch.configs.falcon_mamba_7b",
    "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.configs.llama4_scout_17b_a16e",
    "repro_torch.configs.qwen2_1_5b", "repro_torch.configs.qwen2_5_14b",
    "repro_torch.configs.qwen2_72b", "repro_torch.configs.qwen2_vl_7b",
    "repro_torch.configs.recurrentgemma_9b",
    "repro_torch.configs.seamless_m4t_large_v2",
    "repro_torch.models.common", "repro_torch.models.attention",
    "repro_torch.models.recurrent", "repro_torch.models.blocks",
    "repro_torch.models.lm", "repro_torch.models.api",
    "repro_torch.kernels.mamba_scan", "repro_torch.kernels.mamba_scan.ref",
    "repro_torch.kernels.mamba_scan.kernel",
    "repro_torch.kernels.mamba_scan.ops", "repro_torch.launch.steps",
    "repro_torch.launch.serve", "repro_torch.serve",
    "repro_torch.serve.scheduler")


# recurrentgemma serving: the RG-LRU scan and sliding-window attention
# kernels, the MLP, RoPE and attention beside the blocks that use them
NEW_IN_SLICE_5 = (
    "repro_torch.kernels.rglru_scan", "repro_torch.kernels.rglru_scan.ref",
    "repro_torch.kernels.rglru_scan.kernel",
    "repro_torch.kernels.rglru_scan.ops",
    "repro_torch.kernels.swa_attention",
    "repro_torch.kernels.swa_attention.ref",
    "repro_torch.kernels.swa_attention.kernel",
    "repro_torch.kernels.swa_attention.ops", "repro_torch.models.mlp")

# the backward of the forward-only CUDA kernels (scans, attention)
NEW_IN_SLICE_6 = ("repro_torch.kernels._autograd",)

# the LM training path: checkpoints and the train CLI
NEW_IN_SLICE_9 = ("repro_torch.checkpoint", "repro_torch.checkpoint.io",
                  "repro_torch.checkpoint.manager",
                  "repro_torch.launch.train")


# the paper's remaining parameter-server paths: the row-sharded master
NEW_IN_SLICE_10 = ("repro_torch.cluster.sharded",)

# the process backend: shard servers and workers as spawned processes
NEW_IN_SLICE_11 = ("repro_torch.cluster.procs",)

# packed sequences
NEW_IN_SLICE_13 = ("repro_torch.data.packing",)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "repro"


def test_port_modules_import_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.flat_update.ops" in mods
    for name in (NEW_IN_SLICE_2 + NEW_IN_SLICE_4 + NEW_IN_SLICE_5
                 + NEW_IN_SLICE_6 + NEW_IN_SLICE_9 + NEW_IN_SLICE_10
                 + NEW_IN_SLICE_11 + NEW_IN_SLICE_13):
        assert name in mods, name
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


def test_torch_scripts_import_only_port_torch_numpy_stdlib():
    """The port's scripts (``scripts/torch_*.py``) import no JAX and
    nothing of the JAX package; they may import ``chip_smoke``."""
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert ROOT / "scripts" / "torch_profile_serve.py" in scripts
    allowed = ({"repro_torch", "torch", "numpy", "chip_smoke"}
               | set(sys.stdlib_module_names))
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), (path.name, name)
                assert name.split(".")[0] in allowed, (path.name, name)


def test_every_cuda_source_is_a_library_of_the_loader():
    """``kernels/_build.build_all`` (and so ``chip_smoke.py``) builds
    every CUDA source of the port: each ``csrc/*.cu`` is one Library."""
    code = (
        "import json, repro_torch.kernels.dana_update, "
        "repro_torch.kernels.flat_update, repro_torch.kernels.mamba_scan, "
        "repro_torch.kernels.rglru_scan, "
        "repro_torch.kernels.swa_attention\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({l.name: str(l.source) for l in "
        "_build.LIBRARIES}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    libs = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(map(Path, libs.values())) == sorted(PORT.rglob("*.cu"))
    assert "gap_update" in libs and "mamba_scan" in libs
    assert "rglru_scan" in libs and "swa_attention" in libs
