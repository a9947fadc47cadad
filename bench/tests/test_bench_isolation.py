"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program.  Top-level module names are compared whole:
the port's name, ``repro_torch``, begins with the JAX package's."""
import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

from bench import run

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    sources = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(sources) > 20
    for p in sources:
        assert not set(_imports(p)) & FORBIDDEN, p
    for p in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(p)), p


def _modules_after(code: str):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, torch\n"
        "from pathlib import Path\n"
        "torch.set_num_threads(1)\n"
        "import tempfile\n"
        "from bench.tests.test_bench_harness import make_root, CELL, SEED\n"
        "from bench.harness import run_cell\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    r = make_root(Path(d))\n"
        "    res, _ = run_cell(CELL, SEED, 0.2, True, root=r, device='cpu')\n"
        "assert res['correct'], res\n")
    mods = _modules_after(code)
    assert "repro_torch" in mods and "bench" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import tempfile, torch\n"
            "from pathlib import Path\n"
            "from bench.reference import alexnet, googlenet, ops\n"
            "from bench import inputs, roofline\n"
            "for m, hw in ((alexnet, 67), (googlenet, 64)):\n"
            "    L = m.layers(scale=0.1, num_classes=10)\n"
            "    p = inputs.draw_weights(inputs.generator(1, 'cpu'), L, (3, hw, hw), 'cpu')\n"
            "    ops.forward(L, p, torch.zeros(1, 3, hw, hw))\n"
            # Kind files, loaded from a checkout of their own.
            "from bench.tests.test_bench_kinds import ADD, DWCONV, SHAPE, checkout, network\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    k = ops.Kinds(checkout(Path(d), add=ADD, dwconv=DWCONV))\n"
            "    L = network()\n"
            "    p = inputs.draw_weights(inputs.generator(1, 'cpu'), L, SHAPE, 'cpu', k)\n"
            "    ops.forward(L, p, torch.zeros(1, *SHAPE), kinds=k)\n"
            "    assert roofline.flops_per_image(L, SHAPE, k) > 0\n")
    mods = _modules_after(code)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_the_run_refuses_a_process_that_loaded_the_jax_package(monkeypatch):
    assert run.forbidden_modules(["torch", "repro_torch", "repro_torch.core", "bench"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core", "jaxlib", "flax.linen",
                                  "jax_extra", "reprox"]) == ["flax.linen", "jaxlib", "repro.core"]
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert "repro.core" in run.forbidden_modules()


def test_without_a_card_the_run_prints_no_result_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "alexnet.closed64",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode != 0
    assert "{" not in out.stdout
