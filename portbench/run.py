"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Everything about a cell is data the harness finds by name:
``BENCHMARK.json`` names the cell's configuration and traffic and the
metrics it reports; ``portbench/configs/<config>.json`` holds the
dataset's shapes and the refine options, ``portbench/traffic/<traffic>.json``
the job (the entry point, its keyword arguments and the labelings'
recipe), ``portbench/workloads/<cell>.json`` the limits of the numbers
that decide ``correct``, and ``portbench/metrics/<metric>.py`` reads each
metric from the run.

A job is what a single-cell user runs: the consensus of two labelings
(``plot_contingency_table``), then the entry point on the matrix and the
consensus. Set-up imports the program, draws the inputs on the card from
``--seed`` (``gen.py``) and runs one job of the cell's own shapes; the
window then runs jobs back to back and ends with the last job that
started inside ``--seconds``. With ``--trace 1`` the window runs under
``torch.profiler`` and the per-layer metrics are printed instead of the
end-to-end ones.

One job of the window, drawn from the seed by a reservoir of one, is
judged: when the reservoir takes a job, its outputs are copied to the
host at once and the job's device result is dropped, so the window holds
no more on the card than a user's jobs do; the copy is left out of the
window's seconds. After the window the peak device memory is read, the
program's state is freed, and that job (and every job's consensus) is
judged against the plain reference (``reference/``); each number
compared is printed beside its limit, last on standard error and last in
the result line. The run imports nothing of JAX and nothing of the JAX
package, and fails if either is loaded; it needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

import gen  # noqa: E402

PROGRAM = "scconsensus_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "scconsensus_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A cell's definition, from ``BENCHMARK.json`` and its files."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(root, "BENCHMARK.json")
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.root = root
        self.entry = entry[0]
        self.chips = int(self.entry.get("chips", 1))
        here = os.path.join(root, "portbench")
        self.config = load_json(here, "configs", self.entry["config"] + ".json")
        self.traffic = load_json(here, "traffic",
                                 self.entry["traffic"] + ".json")
        self.limits = load_json(here, "workloads", name + ".json")["limits"]

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    @property
    def kwargs(self) -> Dict:
        """The entry point's keyword arguments: the configuration's refine
        options under the traffic's."""
        return {**self.config.get("refine", {}),
                **self.traffic.get("kwargs", {})}

    @property
    def exact_tree(self) -> bool:
        return int(self.config["n_cells"]) <= int(
            self.kwargs.get("approx_threshold", 100_000))


class Run:
    """What one run measured: the metric readers' input."""

    def __init__(self, cell: Cell, traced: bool):
        self.cell, self.traced = cell, traced
        self.jobs: List[Dict] = []
        self.failed = 0
        self.setup_s = math.nan
        self.window_s = math.nan
        self.peak_bytes = 0
        self.trace: Optional[Dict] = None
        self.checks: Dict[str, Dict] = {}


def _dcs_shape(res) -> Optional[Dict]:
    """The kernel launch's shapes, from the job's cuts (exact silhouette
    only: one launch a job over every cut)."""
    if (res.metrics.get("silhouette") or {}).get("method") != "exact":
        return None
    k = nnz = 0
    for lab in res.dynamic_labels.values():
        valid = lab > 0
        k += int(np.unique(lab[valid]).size)
        nnz += int(valid.sum())
    return {"n": int(res.embedding.shape[0]), "d": int(res.embedding.shape[1]),
            "c": len(res.dynamic_labels), "k": k, "nnz": nnz}


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _job(scc, cell: Cell, inputs: Dict, traced: bool, device: str):
    """One job; returns (its record, the consensus, the result)."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function("portbench.contingency"):
        cons = scc.plot_contingency_table(inputs["sup"], inputs["uns"])
    t1 = time.perf_counter()
    with record_function("portbench.refine"):
        res = getattr(scc, cell.traffic["entry"])(
            inputs["data"], cons, device=device, **cell.kwargs)
    _sync(device)
    t2 = time.perf_counter()
    rec = {"t0": t0, "wall_s": t2 - t0, "contingency_s": t1 - t0,
           "stage_walls_s": dict(res.metrics["stage_walls_s"])}
    if traced:
        rec["spans"] = res.metrics.get("spans")
        rec["dcs"] = _dcs_shape(res)
    return rec, cons, res


def outcome_of(res):
    """The judged job's outputs, copied to the host (the consensus is
    filled in after the window)."""
    import torch

    from reference.judge import Outcome

    de = res.de

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    labels = {int(k.split(":")[1]): np.asarray(v)
              for k, v in res.dynamic_labels.items()}
    sils = {int(i["deep_split"]): float(i.get("silhouette", math.nan))
            for i in res.deep_split_info}
    return Outcome(
        consensus=[],
        de={"cluster_names": list(de.cluster_names), "log_p": host(de.log_p),
            "log_q": host(de.log_q), "log_fc": host(de.log_fc),
            "tested": host(de.tested), "de_mask": host(de.de_mask)},
        union=np.asarray(res.de_gene_union_idx),
        embedding=np.asarray(res.embedding), tree=res.cell_tree,
        labels=labels, silhouettes=sils, nodg=np.asarray(res.nodg))


def quiet_program_log() -> None:
    """The program logs every stage at INFO through its own handler,
    which it installs on its logger only when none is there: install a
    null one first, so warnings still reach standard error (through the
    root logger) and the stage lines do not."""
    log = logging.getLogger(PROGRAM)
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    log.setLevel(logging.WARNING)


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda") -> Run:
    """Set-up, the window and the judgement of one run (on the card; the
    CPU serves the benchmark's own tests)."""
    import torch

    cuda = device == "cuda"

    scc = importlib.import_module(PROGRAM)
    quiet_program_log()
    run = Run(cell, traced)
    inputs = gen.make_inputs(cell.config, cell.traffic, seed, device)
    _job(scc, cell, inputs, False, device)           # warm: the cell's shapes
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rng = gen.rng_for(seed, 4)
    outcome, consensus = None, []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    run.setup_s = time.perf_counter() - T_START
    from torch.profiler import record_function

    with record_function("portbench.window"):
        w0 = time.perf_counter()
        kept_s = 0.0          # the judged job's copies, outside the window
        while not run.jobs or time.perf_counter() - w0 - kept_s < seconds:
            try:
                rec, cons, res = _job(scc, cell, inputs, traced, device)
            except Exception as e:  # a job that fails counts as failed
                run.failed += 1
                run.jobs.append({"t0": time.perf_counter(), "wall_s": math.nan,
                                 "error": repr(e)[:500]})
                print(f"job failed: {e!r}", file=sys.stderr)
                continue
            run.jobs.append(rec)
            consensus.append(cons)
            if rng.random() * len(consensus) < 1.0:   # reservoir of one
                k0 = time.perf_counter()
                with record_function("portbench.keep"):
                    outcome = outcome_of(res)
                kept_s += time.perf_counter() - k0
            del res
        run.window_s = time.perf_counter() - w0 - kept_s
    if prof is not None:
        prof.__exit__(None, None, None)
    run.peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if prof is not None:
        from devtrace import export, summarize

        trace = export(prof, os.path.join(cell.root, "portbench", "_out"),
                       cell.name)
        del prof
        run.trace = summarize(trace, [j for j in run.jobs if "error" not in j])
        del trace
    if outcome is not None:
        outcome.consensus = consensus
    if cuda:
        torch.cuda.empty_cache()
    run.checks = judge_outcome(cell, inputs, outcome)
    return run


def judge_outcome(cell: Cell, inputs: Dict, outcome) -> Dict[str, Dict]:
    """Each limited number of the cell, with its value and limit."""
    from reference.judge import Reference, judge

    want = list(cell.limits)
    if outcome is None:
        return {k: {"value": math.inf, "limit": cell.limits[k]} for k in want}
    values = judge(outcome, Reference(inputs, cell.kwargs), want)
    return {k: {"value": values[k], "limit": float(cell.limits[k])}
            for k in want}


def _finite(x):
    """JSON has no infinities: a number that is not finite prints as
    null."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def metric_reader(root: str, name: str):
    """``portbench/metrics/<name>.py`` of the checkout at ``root``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        v = metric_reader(run.cell.root, m["name"])(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(run: Run, kind: str) -> Dict:
    checks = run.checks
    correct = (run.failed == 0 and bool(run.jobs) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    device = {"platform": "gpu", "kind": kind,
              "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes}
    metrics = read_metrics(run, run.cell.per_layer if run.traced
                           else run.cell.end_to_end)
    line = {"correct": correct, "attempted": len(run.jobs),
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = {k: {"value": _finite(c["value"]),
                          "limit": c["limit"]} for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = banned_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    line = result_line(run, torch.cuda.get_device_name(0))
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
