"""What a run may load: the port and never JAX or the JAX package; the
plain reference nothing of either."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import core

BENCH = Path(core.__file__).resolve().parent


def test_forbidden_names_compare_whole_top_level_names():
    assert core.forbidden_modules(["vatl4pose_tpu_torch", "jaxtyping",
                                   "vatl4pose_tpu_torch.kernels",
                                   "flaxen", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert core.forbidden_modules(["vatl4pose_tpu.ops", "jaxlib",
                                   "flax.linen"]) == \
        ["flax", "jaxlib", "vatl4pose_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_sources_import_nothing_of_the_port_or_jax():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("vatl4pose_tpu_torch", "benchmark") \
                and top not in core.FORBIDDEN, (path, name)


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys, benchmark.reference.judge, "
            "benchmark.reference.training, benchmark.reference.scoring; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vatl4pose_tpu_torch', 'vatl4pose_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_only_port_py_imports_the_port():
    for path in BENCH.rglob("*.py"):
        if path.name == "port.py" or "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] != "vatl4pose_tpu_torch", (path, name)


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, time, torch; torch.set_num_threads(2); "
            "from benchmark import core; "
            "from benchmark.tests.tiny import tiny_parts; "
            "w = 'simplepose_r50.score'; "
            "core.run_cell(w, 7, 0, False, time.perf_counter(), "
            "device='cpu', spec_parts=tiny_parts(w), log=lambda *a: None); "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
