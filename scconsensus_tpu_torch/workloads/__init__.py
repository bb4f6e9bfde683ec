"""Workload zoo: the scenario subsystem.

The port of ``scconsensus_tpu/workloads/``. A scenario owns everything
it is made of: dataset generation, input-labeling construction and
scenario-specific scoring. Four scenarios ship:

  multi_sample    cells drawn from S samples with per-sample
                  shift/library-size confounds; consensus across the
                  samples' own (unaligned) clusterings; scored with
                  per-batch ARI + batch-mixing entropy
                  (``obs.quality`` owns the math).
  cite_dual       dual-modality CITE-seq: an ADT-like low-dimensional
                  modality clustered coarsely × an RNA modality
                  clustered finely.
  atlas_transfer  fit on an atlas split, freeze the consensus model
                  (``serve.model``), classify the query split through
                  the serve driver as a batch workload.
  topo_inputs     the Two-Tier-Mapper-style topology clusterer
                  (``workloads.topology``) as the unsupervised input.

Each scenario declares a ``full`` parameter set and a ``smoke`` set
(≤ 5k cells), the reference's own. A record carries a validated
top-level ``scenario`` section (:func:`validate_scenario`) plus a
``quality.scenario`` scoring block (``obs.quality.
validate_scenario_scores``).

Module-level imports stay torch-free (``obs.export.validate_run_record``
imports :func:`validate_scenario`); the runners import their compute
when they run. Every runner takes ``device``: ``None`` is the card, and
with no card it raises; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

__all__ = [
    "Scenario",
    "ScenarioOutcome",
    "SCENARIOS",
    "get_scenario",
    "scenario_names",
    "run_scenario",
    "validate_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered scenario: the runner module plus its two shapes."""

    name: str
    doc: str
    unit: str
    runner_module: str          # lazy-imported; must expose run(params)
    full: Dict[str, Any]
    smoke: Dict[str, Any]


@dataclasses.dataclass
class ScenarioOutcome:
    """What a scenario runner hands back to its caller: the headline
    plus every record section the scenario produced. ``scenario`` is the
    validated top-level record section; ``quality`` carries the
    scenario scoring block under ``quality["scenario"]``."""

    name: str
    metric: str
    value: float
    unit: str
    scenario: Dict[str, Any]
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    quality: Optional[Dict[str, Any]] = None
    serving: Optional[Dict[str, Any]] = None
    robustness: Optional[Dict[str, Any]] = None
    integrity: Optional[Dict[str, Any]] = None
    residency: Optional[Dict[str, Any]] = None
    kernels: Optional[Dict[str, Any]] = None


SCENARIOS: Dict[str, Scenario] = {
    "multi_sample": Scenario(
        name="multi_sample",
        doc="S-sample batch-effect data, consensus across per-sample "
            "clusterings, per-batch ARI + batch-mixing entropy scoring",
        unit="seconds",
        runner_module="scconsensus_tpu_torch.workloads.multisample",
        full=dict(n_cells=100_000, n_genes=3000, n_clusters=12,
                  n_samples=4, seed=7),
        smoke=dict(n_cells=4000, n_genes=300, n_clusters=4,
                   n_samples=2, seed=7),
    ),
    "cite_dual": Scenario(
        name="cite_dual",
        doc="dual-modality CITE-seq: ADT clustered coarse × RNA "
            "clustered fine as the consensus input pair",
        unit="seconds",
        runner_module="scconsensus_tpu_torch.workloads.citeseq",
        full=dict(n_cells=40_000, n_genes=8000, n_adt=40, k_fine=12,
                  k_coarse=5, seed=7),
        smoke=dict(n_cells=3000, n_genes=300, n_adt=16, k_fine=6,
                   k_coarse=3, seed=7),
    ),
    "atlas_transfer": Scenario(
        name="atlas_transfer",
        doc="fit on an atlas split, classify the query split through "
            "the frozen-model serve path as a batch workload",
        unit="cells/sec",
        runner_module="scconsensus_tpu_torch.workloads.atlas",
        full=dict(n_atlas=20_000, n_query=60_000, n_genes=3000,
                  n_clusters=10, cells_per=512, seed=7),
        smoke=dict(n_atlas=2500, n_query=2000, n_genes=300,
                   n_clusters=5, cells_per=128, seed=7),
    ),
    "topo_inputs": Scenario(
        name="topo_inputs",
        doc="Mapper-style topology clusterer (kNN cover -> local "
            "clustering -> nerve merge) as the unsupervised consensus "
            "input",
        unit="seconds",
        runner_module="scconsensus_tpu_torch.workloads.topo_scenario",
        full=dict(n_cells=50_000, n_genes=3000, n_clusters=10,
                  n_covers=32, seed=7),
        smoke=dict(n_cells=3000, n_genes=300, n_clusters=4,
                   n_covers=12, seed=7),
    ),
}


def scenario_names() -> List[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} (known: {scenario_names()})"
        ) from None


def run_scenario(name: str, overrides: Optional[Dict[str, Any]] = None,
                 smoke: bool = False,
                 workdir: Optional[str] = None,
                 device=None) -> ScenarioOutcome:
    """Run one registered scenario end to end.

    ``smoke`` picks the ≤5k-cell parameter set (the tier-1 lane);
    ``overrides`` lays user/bench keys over the chosen set. ``workdir``
    is for scenarios with durable artifacts (atlas_transfer's frozen
    model) — None means an ephemeral temp dir. ``device``: the card
    by default (raises without one), ``"cpu"`` on request.
    """
    sc = get_scenario(name)
    params = dict(sc.smoke if smoke else sc.full)
    params.update(overrides or {})
    mod = importlib.import_module(sc.runner_module)
    out = mod.run(params, smoke=smoke, workdir=workdir, device=device)
    out.scenario.setdefault("name", name)
    out.scenario["smoke"] = bool(smoke)
    return out


def build_scenario_section(name: str, params: Dict[str, Any],
                           smoke: bool = False) -> Dict[str, Any]:
    """The top-level ``scenario`` record section: which scenario ran,
    at what shape. Scalars only — scoring lives in
    ``quality["scenario"]`` where the quality validators can hold it to
    the same standard as every other quality block."""
    return {
        "name": name,
        "smoke": bool(smoke),
        "params": {
            k: v for k, v in params.items()
            if isinstance(v, (int, float, str, bool))
        },
    }


def validate_scenario(sc: Dict[str, Any]) -> None:
    """Structural validation of a record's top-level ``scenario``
    section (torch-free; ``obs.export.validate_run_record`` calls this).
    Raises ValueError on the first violation."""
    if not isinstance(sc, dict):
        raise ValueError("scenario section: must be an object")
    name = sc.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError("scenario section: name must be a non-empty "
                         "string")
    if name not in SCENARIOS:
        raise ValueError(
            f"scenario section: unknown scenario {name!r} "
            f"(registered: {scenario_names()})"
        )
    params = sc.get("params")
    if not isinstance(params, dict) or not params:
        raise ValueError("scenario section: params must be a non-empty "
                         "object")
    for k, v in params.items():
        if not isinstance(v, (int, float, str, bool)):
            raise ValueError(
                f"scenario section: params[{k!r}] must be a JSON "
                f"scalar, got {type(v).__name__}"
            )
    if "smoke" in sc and not isinstance(sc["smoke"], bool):
        raise ValueError("scenario section: smoke must be a bool")
