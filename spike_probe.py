"""Repeat the fleet's spike soak and steady load run to see how often
their contracts hold, and at which payload.

``chip_smoke.py`` phase 44 runs ``tools/load_run.py --spike-soak``'s
contract once; whether its shed, scale and recovery legs land inside the
15 s run depends on how fast the host's one interpreter serves the wire,
so one run says little. This script runs the same child as phase 44 (the
reference's policy and 0.1 s tick, the reference's ``tools/postmortem.py``
over each work dir) once per payload listed, and prints each run's
outcomes, actuations (seconds after the first) and failed checks::

    python3 spike_probe.py                       # card: 96x8, 128x8
    python3 spike_probe.py --runs 96x12,96x16 --steady 2
    python3 spike_probe.py --phase44             # phase 44 itself first
    python3 spike_probe.py --constant-classify --runs 96x8

``--constant-classify`` (CPU only, in this process) answers every
request with label 1 and no device work: the wire, pool and generator's
own capacity on this host. With ``--rates R1,R2,...`` it then runs the
spike's payload steady at each rate for 4 s and prints the achieved
rate, the late fraction, the served p50 and p99, and the time
``json.loads`` takes on one such request body here::

    python3 spike_probe.py --constant-classify --runs 96x8 --rates 20,60,100
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
import traceback

import chip_smoke as c


def _line(tag, s, checks, t):
    t0 = s["actuations"][0]["ts"] if s["actuations"] else 0.0
    acts = [(a["kind"], a["from"], a["to"], round(a["ts"] - t0, 2))
            for a in s["actuations"]]
    c.log(f"[probe] {tag} in {time.perf_counter() - t:.1f} s: outcomes "
          f"{s['outcome_counts']} achieved {s['achieved_rps']} rps_at_slo "
          f"{s['rps_at_slo']} late {s['late_fraction']} breaches "
          f"{s['breaches']} actuations {acts} failed "
          f"{[n for n, ok in checks if not ok]}")


def _constant(runs, root):
    import numpy as np

    from scconsensus_tpu_torch.serve import model
    from scconsensus_tpu_torch.serve.fleet.autoscale import AutoscalePolicy
    from scconsensus_tpu_torch.serve.fleet.loadgen import run_load

    model.ConsensusModel.classify = lambda self, x: (
        np.ones(len(x), np.int64), np.zeros(len(x)))
    os.environ.update(c.SPIKE_ENV)
    for i, (cells, pumps) in enumerate(runs):
        t = time.perf_counter()
        s = run_load(os.path.join(root, f"s{i}"), device="cpu",
                     policy=AutoscalePolicy.from_env(**c.SPIKE_POLICY),
                     pumps=pumps, **{**c.SPIKE_SOAK, "cells_per": cells})
        s["record_valid"] = "invalid" not in s["record"]
        # the run's checks; no postmortem bundle here
        _line(f"constant classify, cells {cells} pumps {pumps}", s,
              c._spike_checks(s, 1, {}, 0)[:7], t)


def _constant_rates(rates, root):
    import json

    from scconsensus_tpu_torch.serve.fleet.loadgen import (
        _build_request_bodies,
        arrival_offsets,
        resolve_mix,
        run_load,
    )

    kw = {**c.SPIKE_SOAK, "profile": "steady", "duration_s": 4.0,
          "autoscale": False}
    for i, rate in enumerate(rates):
        s = run_load(os.path.join(root, f"r{i}"), device="cpu", pumps=8,
                     **{**kw, "base_rps": rate, "peak_rps": rate})
        lat = s["record"]["serving"]["latency_ms"]
        c.log(f"[probe] constant classify, steady {rate} rps, cells "
              f"{kw['cells_per']} pumps 8: achieved {s['achieved_rps']} late "
              f"{s['late_fraction']} served p50 {lat['p50']} p99 "
              f"{lat['p99']} ms, outcomes {s['outcome_counts']}")
    offs = arrival_offsets("steady", 20.0, 20.0, 2.0, c.SPIKE_SOAK["seed"])
    bodies, _ = _build_request_bodies(offs, resolve_mix(None),
                                      c.SPIKE_SOAK["cells_per"], 120, 4,
                                      c.SPIKE_SOAK["seed"])
    t = time.perf_counter()
    for b in bodies:
        json.loads(b)
    c.log(f"[probe] json.loads of one {len(bodies[0])}-byte body: "
          f"{(time.perf_counter() - t) / len(bodies) * 1e3:.3f} ms (mean of "
          f"{len(bodies)})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="96x8,128x8",
                    help="payloads as CELLSxPUMPS, comma-separated")
    ap.add_argument("--steady", type=int, default=0,
                    help="steady run_load runs alone after the spikes")
    ap.add_argument("--phase44", action="store_true")
    ap.add_argument("--constant-classify", action="store_true")
    ap.add_argument("--rates", default="",
                    help="with --constant-classify: steady rates to run")
    args = ap.parse_args()
    runs = [tuple(int(v) for v in r.split("x"))
            for r in args.runs.split(",") if r]
    root = tempfile.mkdtemp(prefix="spike-probe-")
    if args.constant_classify:
        try:
            _constant(runs, root)
            if args.rates:
                _constant_rates([float(r) for r in args.rates.split(",")],
                                root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        return 0
    launcher = c._start_launcher()
    try:
        c.log(c._smi())
        if args.phase44:
            t = time.perf_counter()
            try:
                c.log(f"[probe] phase 44: {c.phase_fleet_workers(launcher)}")
            except AssertionError:
                traceback.print_exc()
            c.log(f"[probe] phase 44 in {time.perf_counter() - t:.1f} s")
        for i, (cells, pumps) in enumerate(runs):
            w = os.path.join(root, f"s{i}")
            t = time.perf_counter()
            argv = c._load_argv(w, pumps=pumps, policy=c.SPIKE_POLICY,
                                env=c.SPIKE_ENV,
                                **{**c.SPIKE_SOAK, "cells_per": cells})
            s = c._child_summary("spike", c._launch_all(
                launcher, [argv], 300)[0])
            rc, bundle = c._postmortem(launcher, w)
            _line(f"spike cells {cells} pumps {pumps}", s,
                  c._spike_checks(s, 1, bundle, rc), t)
        for i in range(args.steady):
            t = time.perf_counter()
            argv = c._load_argv(os.path.join(root, f"steady{i}"), fresh=True)
            s = c._child_summary("load", c._launch_all(
                launcher, [argv], 300)[0])
            c.log(f"[probe] steady alone in {time.perf_counter() - t:.1f} "
                  f"s: offered {s['offered']} good {s['good']} rps_at_slo "
                  f"{s['rps_at_slo']} slo_held {s['slo_held']} breaches "
                  f"{s['breaches']} scales {s['scales']}")
    finally:
        c._stop_launcher(launcher)
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
