"""The port's two worked examples run end to end on the CPU at a tiny
size: ``examples/torch_quickstart.py`` and
``examples/torch_device_resident.py``, the counterparts of the
reference's (``tests/test_quickstart.py``). Each runs in a child process
with ``--device cpu``; ``tests/test_torch_scaffold.py`` scans both for
imports of JAX and the reference."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(script: str, *args: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=cwd,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_torch_quickstart_runs(tmp_path):
    proc = _run("torch_quickstart.py", "--cells", "600", "--genes", "400",
                "--outdir", str(tmp_path), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[torch-quickstart] done:" in proc.stdout
    assert "'device': 'cpu'" in proc.stdout
    assert "resume: DE stage skipped" in proc.stdout
    assert (tmp_path / "Contingency_Table.pdf").exists()
    assert (tmp_path / "Reclustered_DE_edgeR_Heatmap.pdf").exists()


def test_torch_device_resident_example_runs(tmp_path):
    proc = _run("torch_device_resident.py", "--cells", "500", "--genes",
                "300", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "on cpu" in proc.stdout and "device-resident: True" in proc.stdout
    assert "refine over device matrix" in proc.stdout
    assert "crossed as the triplet" in proc.stdout
    assert "refine over csr_to_device matrix" in proc.stdout
