"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program, the repository's tests or its
tools. Top-level module names are compared whole: mbb_emcee_tpu_torch is
not mbb_emcee_tpu."""

import ast
import subprocess
import sys

import pytest

from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "mbb_emcee_tpu"}
REFERENCE_FORBIDDEN = FORBIDDEN | {"mbb_emcee_tpu_torch", "tests", "tools"}
FILES = sorted(p for p in bench.HERE.rglob("*.py")
               if "tests" not in p.relative_to(bench.HERE).parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert "mbb_emcee_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(bench.ROOT).as_posix())
def test_no_forbidden_import(path):
    rel = path.relative_to(bench.HERE).parts
    bad = REFERENCE_FORBIDDEN if rel[0] == "reference" else FORBIDDEN
    assert not top_level_imports(path) & bad


def test_nothing_reads_the_jax_benchmark():
    for path in FILES:
        text = path.read_text()
        assert "bench.py\"" not in text and "BENCH_r" not in text


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))")],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=600,
        check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.model, "
                           "portbench.reference.oracle, portbench.check")
    assert not loaded & REFERENCE_FORBIDDEN


def test_a_cpu_run_loads_no_jax():
    """Every module of the harness imported and a short catalog request
    driven on the CPU, then sys.modules as the harness reads it."""
    code = (
        "import portbench.harness as h, portbench.faults, portbench.trace\n"
        "from portbench.bench import Cell, reader\n"
        "from portbench.workload import Workload\n"
        "c = Cell('catalog_cli_derived')\n"
        "c.config = dict(c.config, nsources=4, missing_every=2)\n"
        "c.traffic = dict(c.traffic, nburn=4, nsteps=8)\n"
        "[reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "w = Workload(c.config, c.traffic, device='cpu')\n"
        "win = h.measure(w, 7, 0.0)\n"
        "assert not h.forbidden_modules(), h.forbidden_modules()\n")
    loaded = _loaded_after(code)
    assert "mbb_emcee_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
