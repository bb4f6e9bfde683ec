"""The port's fleet chaos worker and load generator, end to end on the CPU.

One child of ``python -m scconsensus_tpu_torch.serve.fleet.soak --device
cpu`` per fleet plan of the reference's chaos matrix
(``tools/chaos_run.py``: ``swap-under-load``, ``replay-across-replicas``,
``kill-replica-under-load``), at the plan's parameters and held to the
checks the tool states for it. The kill plan's directory also goes through
the reference's ``tools/postmortem.py`` (stdlib, run as a subprocess),
whose bundle must show both attempts of a retried request under one trace,
joined across two sources, and the kill on the timeline. Then one
``run_load`` through the wire front, whose record (with its ``loadgen``
section) passes both packages' validators.

The children import only the port; all of them start at once.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from scconsensus_tpu.obs.export import validate_run_record as ref_validate
from scconsensus_tpu_torch.obs.export import validate_run_record
from scconsensus_tpu_torch.serve.fleet.loadgen import run_load

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/chaos_run.py's default request count
N_REQUESTS = 16


def _worker(workdir, n_requests, args, summary="FLEET_SOAK_SUMMARY.json"):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SCC_FAULT_PLAN", "SCC_SERVE_LEDGER_DIR")}
    env["OMP_NUM_THREADS"] = "2"
    path = os.path.join(workdir, summary)
    cmd = [sys.executable, "-m", "scconsensus_tpu_torch.serve.fleet.soak",
           "--dir", workdir, "--requests", str(n_requests), "--summary",
           path, "--device", "cpu"] + args
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), path


def _finish(proc, path):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode in (0, 1), err[-2000:]
    with open(path) as f:
        return proc.returncode, json.load(f)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """The three plans' workers, started together (replay's second run
    reuses its first run's model, so it follows that one)."""
    root = tmp_path_factory.mktemp("fleet-chaos")
    swap_n = max(N_REQUESTS, 12)
    kill_n = max(N_REQUESTS, 30)
    dirs = {k: str(root / k) for k in ("swap", "replay", "kill")}
    procs = {
        "swap": _worker(dirs["swap"], swap_n, [
            "--fresh", "--replicas", "3",
            "--swap-after", str(max(int(swap_n * 0.33), 1))]),
        "replay1": _worker(dirs["replay"], N_REQUESTS, [
            "--fresh", "--replicas", "1"], summary="REPLAY_R1.json"),
        "kill": _worker(dirs["kill"], kill_n, [
            "--fresh", "--replicas", "2",
            "--kill-after", str(max(int(kill_n * 0.2), 1)),
            "--heartbeat", "0.15", "--cells", "256", "--concurrency", "6"]),
    }
    out = {k: _finish(*v) for k, v in procs.items()}
    out["replay3"] = _finish(*_worker(dirs["replay"], N_REQUESTS, [
        "--replicas", "3"], summary="REPLAY_R3.json"))
    out["dirs"] = dirs
    return out


def test_swap_under_load(plans):
    rc, s = plans["swap"]
    sv = s["record"]["serving"]
    assert rc == 0, "worker exited 0 (wire+fleet accounting held)"
    assert s["resolved"] == s["requests"] and s["accounting_ok"] is True
    assert s["swapped"] and s["post_swap_responses"]
    fps = set(s["fps_seen"])
    assert fps and fps <= {s["fp_v1"], s["fp_v2"]}
    assert s["post_swap_pure"] is True
    assert len(sv["fleet"]["swaps"]) >= 1


def test_replay_across_replicas(plans):
    rc1, s1 = plans["replay1"]
    rc3, s3 = plans["replay3"]
    assert rc1 == 0 and s1["ok"] and s1["replicas"] == 1
    assert rc3 == 0 and s3["ok"] and s3["replicas"] == 3
    assert s1["labels_sha"] == s3["labels_sha"]
    assert s1["fp_v1"] == s3["fp_v1"]


def test_kill_replica_under_load(plans):
    rc, s = plans["kill"]
    assert rc == 0, "accounting held across the kill"
    assert any(k.get("respawned") is not None for k in s["kills"])
    assert s["resolved"] == s["requests"]
    assert all(k in ("ok", "degraded", "quarantined")
               for k in s["outcome_counts"])
    assert len(s["retried"]) >= 1 and s["trace_continuity"] is True


def test_the_postmortem_bundle_over_the_kill(plans):
    _, s = plans["kill"]
    workdir = plans["dirs"]["kill"]
    bundle_path = os.path.join(workdir, "POSTMORTEM_BUNDLE.json")
    pm = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "postmortem.py"),
         workdir, "--out", bundle_path, "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert pm.returncode == 0, pm.stderr[-2000:]
    with open(bundle_path) as f:
        bundle = json.load(f)
    assert bundle.get("traces")
    two_attempt = {
        tid: evs for tid, evs in bundle["traces"].items()
        if len([e for e in evs if e.get("kind") == "wire_response"]) >= 2
    }
    retried_ids = {atts[0].get("trace_id")
                   for atts in s["retried"].values() if atts}
    assert any(tid in two_attempt for tid in retried_ids if tid)
    assert any(len({e.get("src") for e in evs}) >= 2
               for evs in two_attempt.values())
    assert any(e.get("kind") == "replica_kill"
               for e in bundle.get("timeline") or [])


def test_run_load_record_passes_both_validators(tmp_path):
    """A short open-loop run (Poisson, 10 rps, 3 s, the zoo's equal mix,
    autoscaler on) through the real wire front: nothing lost, and the
    record with its ``loadgen`` section is valid in both packages."""
    s = run_load(str(tmp_path), profile="steady", base_rps=10.0,
                 duration_s=3.0, seed=7, replicas=1, fresh=True,
                 device="cpu")
    assert s["ok"] and s["accounting_ok"]
    assert s["sent"] == s["offered"] > 0
    assert set(s["mix_counts"]) <= {"multi_sample", "cite_dual",
                                    "atlas_transfer", "topo_inputs"}
    rec = s["record"]
    lg = rec["loadgen"]
    assert lg["offered"] == s["offered"] and "autoscale" in lg
    assert rec["extra"]["platform"] == "cpu"
    validate_run_record(rec)
    ref_validate(rec)


def test_the_postmortem_bundle_over_a_scaling_load_run(tmp_path,
                                                       monkeypatch):
    """``tools/load_run.py``'s postmortem checks over a ``run_load`` work
    dir (:229-260): the bundle is built, every actuation of the run lies
    on the merged timeline, and the record's replica resizes are mirrored
    there. A policy whose scale-up pressure always holds (``burn_up`` 0,
    which any burn meets) makes the actuations certain on a loaded CPU;
    what is held is the evidence trail, not the control law."""
    from scconsensus_tpu_torch.serve.fleet.autoscale import AutoscalePolicy

    monkeypatch.setenv("SCC_AUTOSCALE_TICK_S", "0.1")
    policy = AutoscalePolicy.from_env(min_replicas=1, max_replicas=2,
                                      burn_up=0.0, burn_down=-1.0,
                                      up_ticks=1, cooldown_ticks=1)
    workdir = str(tmp_path)
    s = run_load(workdir, profile="steady", base_rps=10.0, duration_s=2.0,
                 seed=7, replicas=1, fresh=True, policy=policy,
                 device="cpu")
    assert s["ok"] and "invalid" not in s["record"]
    acts = s["actuations"]
    assert [(a["kind"], a["from"], a["to"]) for a in acts] == [
        ("scale_up", 1, 2)]
    # the summary beside the run, as tools/load_run.py writes it
    with open(os.path.join(workdir, "LOAD_SUMMARY.json"), "w") as f:
        json.dump(s, f, indent=1, default=str)
    bundle_path = os.path.join(workdir, "POSTMORTEM_BUNDLE.json")
    pm = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "postmortem.py"),
         workdir, "--out", bundle_path, "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert pm.returncode == 0, pm.stderr[-2000:]
    with open(bundle_path) as f:
        timeline = json.load(f).get("timeline") or []
    assert timeline
    tl_acts = [e for e in timeline if e.get("kind") == "actuation"]
    assert len(tl_acts) >= len(acts)
    assert any(e.get("kind") == "replica_scale" for e in timeline)
