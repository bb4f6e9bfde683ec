"""The readings a cell's limits are set from, many seeds in one process.

    python portbench/readings.py --workload <cell> --seeds 11,12,...
                                 [--control 1] [--out <file.jsonl>]

For each seed: draw the inputs, run one job of the cell through the
program (the first seed's job also builds and warms up), judge it against
the reference, and with ``--control 1`` judge the control too (the
reference in float32 under TF32 matrix products, ``reference/control.py``)
against the same reference. Every name the judge knows is read, not only
the cell's limited ones. One JSON line a seed and side goes to standard
output and to ``--out``. The limits in ``workloads/<cell>.json`` come
from these readings: above the program's largest and below the
control's smallest.
"""

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import gen  # noqa: E402
import run as harness  # noqa: E402


def read_seed(cell, seed: int, control: bool, device: str = "cuda"):
    """[(side, numbers, seconds of the side's outcome, seconds of the
    reference)] of one seed."""
    import torch

    from reference.control import control_outcome
    from reference.judge import (EXACT_TREE_NUMBERS, NUMBERS, POOL_NUMBERS,
                                 Reference, judge)

    scc = importlib.import_module(harness.PROGRAM)
    harness.quiet_program_log()
    other = POOL_NUMBERS if cell.exact_tree else EXACT_TREE_NUMBERS
    want = [n for n in NUMBERS if n not in other]
    inputs = gen.make_inputs(cell.config, cell.traffic, seed, device)
    t0 = time.perf_counter()
    _, cons, res = harness._job(scc, cell, inputs, False, device)
    outcome = harness.outcome_of(res)
    outcome.consensus = [cons]
    del res
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = Reference(inputs, cell.kwargs)
    numbers = judge(outcome, ref, want)
    t2 = time.perf_counter()
    out = [("program", numbers, t1 - t0, t2 - t1)]
    if control:
        ctl = control_outcome(inputs, cell.kwargs, cell.exact_tree)
        t3 = time.perf_counter()
        out.append(("control", judge(ctl, ref, want), t3 - t2, 0.0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            for side, nums, secs, judge_s in read_seed(
                    cell, seed, bool(args.control)):
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "side": side, "seconds": secs,
                                   "judge_seconds": judge_s,
                                   "numbers": nums}, default=str)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
