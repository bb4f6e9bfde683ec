"""Nothing the benchmark imports is JAX or the JAX package, by whole
top-level module names; without a card a run fails and prints no result."""

import ast
import json
import os
import subprocess
import sys

import pytest

import run as harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _sources():
    for d, _, files in os.walk(BENCH):
        if "_out" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_banned_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(harness.BANNED), path
    # nor the repository's other harnesses and records
    assert not tops & {"bench", "chip_smoke", "tools", "evidence"}, path


def test_top_level_names_compared_whole():
    assert harness.PROGRAM.split(".")[0] not in harness.BANNED
    assert "scconsensus_tpu" in harness.BANNED
    sys.modules.setdefault("scconsensus_tpu_torch_probe_x", sys)
    try:
        assert "scconsensus_tpu_torch_probe_x" not in \
            harness.banned_modules()
    finally:
        del sys.modules["scconsensus_tpu_torch_probe_x"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, readings, devtrace, roofline\n"
        "import reference.judge, reference.control\n"
        "import scconsensus_tpu_torch, scconsensus_tpu_torch.models.pipeline\n"
        "print(run.banned_modules())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_without_a_card_a_run_fails_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tm100k.wilcox",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_with_only_the_benchmark_files_a_run_fails(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tm100k.wilcox",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines()
                if line.startswith("{")]
    json.load(open(tmp_path / "BENCHMARK.json"))
