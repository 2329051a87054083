"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast
import subprocess
import sys

import pytest

import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "tests" not in p.parts)


def tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_import(path):
    assert not set(tops(path)) & set(harness.FORBIDDEN)
    assert not set(tops(path)) & {"bench", "exp", "chip_smoke"}


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "dynamictreeattn_tpu_torch" not in set(tops(path))


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("dynamictreeattn_tpu_torch_probe_", sys)
    assert "dynamictreeattn_tpu_torch_probe_" not in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; import tiny, harness; "
            "d = harness.load_module(harness.BENCH / 'drivers' / 'rollout.py'); "
            "d.run(tiny.ctx(tiny.cell(tiny.ROLLOUT, tiny.ROLLOUT_LIMITS))); "
            "print(harness.forbidden_modules())" % (str(harness.BENCH / "tests"), str(harness.BENCH),
                                                   str(harness.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
