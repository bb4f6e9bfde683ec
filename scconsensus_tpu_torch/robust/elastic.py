"""Elastic mesh execution: device-loss recovery and shape-changing resume.

The port's copy of ``scconsensus_tpu/robust/elastic.py``. One
:class:`ElasticMeshSupervisor` per ``refine()`` run owns the mesh of the
sharded paths (``parallel.mesh.auto_mesh`` / an explicit ``Mesh``) and
implements the two halves of elasticity:

**In-process device loss.** A stage failing with a ``device_lost``-class
error (``robust.retry``'s classification: the CUDA runtime's sticky
context errors, the injected ``device_loss`` class) retries through the
typed policy with the supervisor's :meth:`loss_handler` as the
``on_device_loss`` hook. The supervisor probes each shard's device
(a tiny tensor round trip and ``torch.cuda.synchronize``, inside
``try``), rebuilds the mesh on the survivors, records the transition on
the run's robustness log, and the stage re-enters. An indistinct failure,
where every device still answers the probe (what an injected fault looks
like), halves onto the lowest shard ids: 8 → 4 → 2 → 1. The sharded
engines lay their operands out per call (``pad_and_shard`` against the
mesh they are handed), so the re-entered stage re-pads onto the new
shard count by construction; a mesh shrunk to one shard serves ``None``,
the serial path.

**Across processes**, as the reference runs it (``jax.distributed``,
measured in two CPU processes). The reference's probe answers for every
device of the mesh, the other processes' too, so an injected loss is
indistinct there and every process halves onto the lowest global ids.
Here a rank probes its own shards and counts every other rank's as
answering, which gives the same survivors. Then:

  * a rank that holds every survivor goes on alone, on a one-process
    mesh of those shards (``procs=1``, their ids kept): it records the
    reference's transition (``from_devices`` every global id,
    ``to_devices`` the survivors), clears the upload cache, re-enters
    the stage from its checkpoint and makes no collective across the
    group from then on;
  * a rank that holds none raises :class:`DeviceLossUnrecoverable`
    naming the ranks that do (the reference's process there is left with
    a mesh it cannot address and fails on JAX's non-addressable fetch);
  * survivors spread over several ranks would need a subgroup that every
    rank builds; the reference gives no working case to hold one to, so
    every rank raises :class:`DeviceLossUnrecoverable`.

A loss that fires in one rank only (a real fault seen by one process)
leaves the others inside their next collective until the group's
timeout: the reference shares that hazard, and no agreement protocol is
added here.

**Shape-changing resume.** Stage artifacts and the ``_WilcoxCkpt`` bucket
blocks carry a ``mesh_shape`` stamp (``parallel.mesh.mesh_shape_meta``,
the reference's JSON). They hold mesh-invariant results, so a store
written on 8 shards resumes with identical labels on 4, 2 or 1; when a
resume adopts state written on a larger mesh the supervisor stamps a
``cause: "resume"`` transition, so the record shows the crossing.

Gated by ``SCC_ELASTIC`` (default on; with no fault the supervisor costs
one attribute read per stage); ``SCC_ELASTIC_MIN_DEVICES`` floors the
shrink ladder. Only an injected loss is testable without a dying card: a
real sticky CUDA error fails the probe's synchronize, and a device that
hangs is the stall watchdog's territory, not the probe's.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import torch

from scconsensus_tpu_torch.config import env_flag
from scconsensus_tpu_torch.robust import record as robust_record

__all__ = [
    "ElasticMeshSupervisor",
    "elastic_enabled",
    "resume_crossing_from_ids",
    "DeviceLossUnrecoverable",
]

_log = logging.getLogger("scconsensus_tpu_torch")


class DeviceLossUnrecoverable(RuntimeError):
    """A device was lost and there is no smaller mesh to shrink to (the
    floor is ``SCC_ELASTIC_MIN_DEVICES``, default 1). Raised from the
    retry policy's device-loss hook, it leaves the stage guard at once:
    retrying cannot help."""


def elastic_enabled() -> bool:
    return bool(env_flag("SCC_ELASTIC"))


def resume_crossing_from_ids(meta: Optional[Dict[str, Any]],
                             to_ids: List[int]) -> Optional[List[int]]:
    """The crossing rule, in one place (:71-93): the sorted stored shard
    ids when ``meta``'s ``mesh_shape`` stamp names a strictly larger set
    than the live ``to_ids`` (this resume shrinks), else None (the same
    shape, growth and unstamped artifacts are no crossing). The
    supervisor's artifact resumes and the Wilcoxon bucket blocks both
    route through here."""
    shape = (meta or {}).get("mesh_shape")
    if not isinstance(shape, dict):
        return None
    from_ids = shape.get("device_ids")
    if not isinstance(from_ids, list) or not from_ids:
        n = shape.get("n_devices")
        if not isinstance(n, int) or n < 1:
            return None
        from_ids = list(range(n))
    from_ids = sorted(int(d) for d in from_ids)
    if not (set(int(d) for d in to_ids) < set(from_ids)):
        return None
    return from_ids


def _nbytes(x) -> int:
    """Bytes of a tensor, a numpy array or a ``DeviceCSR`` (its triplet)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return sum(_nbytes(getattr(x, f)) for f in ("values", "indices", "indptr"))


class ElasticMeshSupervisor:
    """Owns the mesh of one pipeline run and shrinks it on device loss.

    Stage closures read :attr:`mesh` at call time (never capture it):
    after a loss the property serves the rebuilt, smaller mesh, and the
    retrying stage re-enters against it. A mesh shrunk to one shard
    serves ``None``, the serial path.
    """

    def __init__(self, devices: Optional[List[torch.device]] = None,
                 ids: Optional[List[int]] = None,
                 axis_name: Optional[str] = None, auto: bool = True,
                 device=None):
        from scconsensus_tpu_torch.parallel.mesh import CELL_AXIS

        self.axis_name = axis_name or CELL_AXIS
        # without a shard list the mesh follows auto_mesh (every visible
        # card, serial below 2); an explicit list pins the starting mesh
        self._device = device
        self._shards: Optional[List[Tuple[int, torch.device]]] = None
        # (processes, this one's rank) of the shard list's split
        self._split: Tuple[int, int] = (1, 0)
        if devices is not None or not auto:
            devices = list(devices or [])
            ids = list(range(len(devices))) if ids is None else list(ids)
            self._shards = list(zip((int(i) for i in ids), devices))
        self._mesh = None
        self._mesh_built = False
        self.min_devices = max(int(env_flag("SCC_ELASTIC_MIN_DEVICES")), 1)
        self.live_state_bytes = 0
        self._resume_stamped: set = set()

    # -- construction ------------------------------------------------------
    @classmethod
    def resolve(cls, mesh, device=None
                ) -> Tuple[Optional["ElasticMeshSupervisor"], Any]:
        """The pipeline's mesh policy, supervised (:124-149).

        ``mesh`` is ``refine()``'s argument: "auto", an explicit
        ``parallel.mesh.Mesh``, or None; ``device`` the run's device.
        Returns ``(supervisor, initial_mesh)``; the supervisor is None
        when ``SCC_ELASTIC`` is off (the caller uses ``initial_mesh``
        directly). A serial run still gets one: it cannot lose a device,
        but it can resume artifacts written on a larger mesh, and that
        shrink is stamped."""
        from scconsensus_tpu_torch.parallel.mesh import auto_mesh, require_mesh

        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', a Mesh or None, "
                                 f"got {mesh!r}")
            if not elastic_enabled():
                return None, auto_mesh(device)
            sup = cls(auto=True, device=device)
        elif mesh is None:
            if not elastic_enabled():
                return None, None
            sup = cls(devices=[], auto=False)
        else:
            mesh = require_mesh(mesh)
            if not elastic_enabled():
                return None, mesh
            sup = cls(devices=list(mesh.devices), ids=list(mesh.ids),
                      axis_name=mesh.axis_name, auto=False)
            # the caller's mesh itself until a shrink
            sup._split = (mesh.procs, mesh.rank)
            sup._mesh, sup._mesh_built = mesh, True
        return sup, sup.mesh

    def _shard_list(self) -> List[Tuple[int, torch.device]]:
        if self._shards is None:
            from scconsensus_tpu_torch.parallel.mesh import auto_mesh

            m = auto_mesh(self._device, self.axis_name)
            self._shards = (list(zip(m.ids, m.devices)) if m is not None
                            else [])
            if m is not None:
                self._split = (m.procs, m.rank)
        return self._shards

    def _local_positions(self) -> range:
        """The positions of this process's shards in the shard list."""
        procs, rank = self._split
        per = len(self._shard_list()) // procs
        return range(rank * per, (rank + 1) * per)

    @property
    def mesh(self):
        """The current mesh (None = serial). Rebuilt lazily after a
        shrink; repeat reads between transitions return the same object."""
        if not self._mesh_built:
            shards = self._shard_list()
            if len(shards) < 2:
                self._mesh = None  # the auto_mesh serial policy
            else:
                from scconsensus_tpu_torch.parallel.mesh import Mesh

                self._mesh = Mesh(tuple(d for _, d in shards),
                                  tuple(i for i, _ in shards),
                                  self.axis_name, *self._split)
            self._mesh_built = True
        return self._mesh

    @property
    def n_devices(self) -> int:
        return max(len(self._shard_list()), 1)

    def device_ids(self) -> List[int]:
        from scconsensus_tpu_torch.parallel.mesh import mesh_device_ids

        return mesh_device_ids(self.mesh)

    def shape_meta(self) -> Dict[str, Any]:
        from scconsensus_tpu_torch.parallel.mesh import mesh_shape_meta

        return mesh_shape_meta(self.mesh, self.axis_name)

    # -- live-state accounting --------------------------------------------
    def note_live_state(self, *arrays) -> None:
        """Declare the sharded working set (re-laid-out on every shrink);
        its byte count rides each transition's recovered_state_bytes."""
        self.live_state_bytes = sum(_nbytes(x) for x in arrays)

    # -- in-process device loss -------------------------------------------
    @staticmethod
    def _probe_device(dev: torch.device) -> bool:
        """A tiny round trip through the device. A lost card, or one whose
        context a sticky error poisoned, raises out of the allocation, the
        synchronize or the copy back; False then, never a raise."""
        try:
            x = torch.ones(8, dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return float(x.sum().cpu()) == 8.0
        except Exception:
            return False

    def survivors(self) -> List[Tuple[int, torch.device]]:
        """The shards whose device answers the probe (each distinct
        device of this process probed once; another rank's shards answer,
        as every device answers the reference's probe)."""
        shards = self._shard_list()
        local = self._local_positions()
        alive = {d: self._probe_device(d)
                 for d in {shards[p][1] for p in local}}
        return [(i, d) for p, (i, d) in enumerate(shards)
                if p not in local or alive[d]]

    def shrink(self, stage: str) -> None:
        """Rebuild the mesh on the surviving shards after a device_lost
        failure at ``stage`` (:222-272). Shards of a device that fails the
        probe are dropped exactly; an indistinct loss (every device
        answers: the injected case, and transient wedges) halves onto the
        lowest ids, so the ladder is deterministic: 8 → 4 → 2 → 1. Raises
        :class:`DeviceLossUnrecoverable` at the
        ``SCC_ELASTIC_MIN_DEVICES`` floor. On a mesh that spans processes
        the rank that holds every survivor goes on alone and every other
        rank raises :class:`DeviceLossUnrecoverable` (the module
        docstring)."""
        with robust_record.timed():
            before = self._shard_list()
            from_ids = sorted(i for i, _ in before) if before else [0]
            alive = self.survivors()
            if len(alive) >= len(before):
                # indistinct failure: deterministic halving, low ids kept
                alive = sorted(before, key=lambda s: s[0])
                alive = alive[: max(len(alive) // 2, 1)]
            if len(alive) < self.min_devices or not alive or (
                len(alive) >= len(before) and before
            ):
                raise DeviceLossUnrecoverable(
                    f"device lost at {stage} with no smaller mesh to "
                    f"shrink to ({len(before)} -> {len(alive)} devices; "
                    f"floor SCC_ELASTIC_MIN_DEVICES={self.min_devices})"
                )
            if self._split[0] > 1:
                self._leave_group(stage, before, alive)
            self._shards = list(alive)
            self._mesh_built = False  # the next .mesh read rebuilds
            # cached uploads may live on the lost device: evict, so the
            # re-entered stage stages its inputs again instead of
            # reading a dead buffer
            from scconsensus_tpu_torch.utils.devcache import clear_cache

            clear_cache()
            to_ids = sorted(i for i, _ in alive)
            robust_record.note_mesh_transition(
                stage=stage, from_devices=from_ids, to_devices=to_ids,
                recovered_state_bytes=self.live_state_bytes,
                cause="device_loss",
            )
            _log.warning(
                "elastic mesh: device loss at %s; mesh shrunk %d -> %d "
                "shards (%s); the stage re-enters from its last finished "
                "checkpoint", stage, len(before), len(alive), to_ids)

    def _leave_group(self, stage: str, before, alive) -> None:
        """The survivors of a shrink across processes: this rank goes on
        alone on them when it holds them all, else it raises."""
        procs, rank = self._split
        per = len(before) // procs
        owner = {i: p // per for p, (i, _) in enumerate(before)}
        holders = sorted({owner[i] for i, _ in alive})
        ids = sorted(i for i, _ in alive)
        if len(holders) > 1:
            raise DeviceLossUnrecoverable(
                f"device lost at {stage} on a mesh across {procs} "
                f"processes: the surviving shards {ids} are spread over "
                f"ranks {holders}, and a smaller mesh across them would "
                "need a subgroup that every rank builds")
        if holders != [rank]:
            raise DeviceLossUnrecoverable(
                f"device lost at {stage} on a mesh across {procs} "
                f"processes: the surviving shards {ids} are all on rank "
                f"{holders[0]}, which goes on alone; rank {rank} holds "
                "none of them")
        self._split = (1, 0)

    def loss_handler(self, stage: str):
        """The ``on_device_loss`` hook for ``robust.retry`` at ``stage``."""
        def _handle(_attempt: int) -> None:
            self.shrink(stage)

        return _handle

    # -- shape-changing resume ---------------------------------------------
    def note_artifact_meta(self, stage: str,
                           meta: Optional[Dict[str, Any]]) -> None:
        """Called when a stage resumes from a stored artifact: if it was
        written on a larger mesh than this run's, stamp the crossing as a
        ``cause: "resume"`` transition, once per (stage, shape)."""
        to_ids = self.device_ids()
        from_ids = resume_crossing_from_ids(meta, to_ids)
        if from_ids is None:
            return  # the same shape, growth or no stamp: no crossing
        key = (stage, tuple(from_ids), tuple(to_ids))
        if key in self._resume_stamped:
            return
        self._resume_stamped.add(key)
        size = int(((meta or {}).get("_integrity") or {}).get("size") or 0)
        robust_record.note_mesh_transition(
            stage=stage, from_devices=from_ids, to_devices=to_ids,
            recovered_state_bytes=size, cause="resume",
        )
        _log.info(
            "elastic mesh: stage %r resumed an artifact written on %d "
            "shard(s) onto %d", stage, len(from_ids), len(to_ids))
