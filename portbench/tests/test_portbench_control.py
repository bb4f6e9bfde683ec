"""The control on the card: the reference in float32 under TF32 matrix
products, put in the program's place, must come out not correct, while
the program's own job is correct against the same reference. At a size
a test run holds; the cell-sized readings come from ``readings.py``."""

import pytest

import readings
import run as harness
from conftest import make_root

SMALL = {"n_cells": 6000, "n_genes": 3000, "n_clusters": 8,
         "n_markers_per_cluster": 40}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["exact", "pool"])
@pytest.mark.parametrize("seed", [5, 2**31 + 11, 97])
def test_control_fails_and_program_passes(cuda, tmp_path, seed, branch):
    root = make_root(tmp_path, branch=branch, sizes=SMALL)
    cell = harness.Cell("tiny.wilcox", root)
    out = dict((side, nums) for side, nums, *_ in
               readings.read_seed(cell, seed, control=True, device=cuda))

    def fails(nums):
        return [k for k, lim in cell.limits.items() if nums[k] > lim]

    assert fails(out["program"]) == []
    assert fails(out["control"])
