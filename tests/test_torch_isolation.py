"""The port stands alone: importing every ``repro_torch`` module, and what
chip_smoke.py imports, loads no JAX and nothing of the JAX package."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def _chip_smoke_imports():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    modules = _port_modules() + _chip_smoke_imports()
    for name in ("repro_torch.core.synthesizer",
                 "repro_torch.kernels.conv_mapmajor.ops",
                 "repro_torch.artifacts.codec", "repro_torch.artifacts.store",
                 "repro_torch.nn.attention", "repro_torch.nn.model",
                 "repro_torch.configs.qwen2_7b", "repro_torch.serving.engine",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.launch.specs", "repro_torch.optim.adamw",
                 "repro_torch.checkpoint.ckpt", "repro_torch.data.pipeline"):
        assert name in modules, name
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_import():
    """A static check besides the runtime one: no source line of the port
    or of chip_smoke.py imports jax or the reference package."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, n)


SUBPACKAGES = sorted(
    name for name in os.listdir(os.path.join(SRC, "repro_torch"))
    if os.path.isfile(os.path.join(SRC, "repro_torch", name, "__init__.py")))


def test_subpackages_are_found():
    assert {"artifacts", "checkpoint", "configs", "core", "data", "device",
            "launch", "nn", "obs", "optim"} <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_each_subpackage_imports_first(sub):
    """A user may import any subpackage before the others: each one, alone
    in a fresh interpreter, imports without an import cycle."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", f"import repro_torch.{sub}"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
