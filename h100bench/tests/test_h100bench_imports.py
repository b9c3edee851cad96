"""Nothing the harness loads imports JAX, the JAX package or the
repository's JAX-era scripts; the reference imports nothing of the
program; without a card a run fails and prints no result."""
import ast
import json
import os
import subprocess
import sys

import pytest

from h100bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "reindexer_tpu", "bench", "chip_smoke",
             "tools"}
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), spec.ROOT)
    for d, _, files in os.walk(spec.BENCH_DIR) for f in files
    if f.endswith(".py") and "__pycache__" not in d)


def top_level_imports(path: str) -> set:
    with open(os.path.join(spec.ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_top_level_names_compare_whole():
    # the port's name begins with the JAX package's: only the whole top
    # level name may match
    assert "reindexer_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "reindexer_tpu.core".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", ["h100bench/reference.py",
                                  "h100bench/control.py"])
def test_reference_and_control_import_nothing_of_the_program(path):
    assert "reindexer_tpu_torch" not in top_level_imports(path)
    assert not {n for n in top_level_imports(path)
                if n.startswith("h100bench")}


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from h100bench.harness import runner; import h100bench.control;"
            " import reindexer_tpu_torch; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout.replace("'", '"'))) & FORBIDDEN


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         spec.benchmark()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
