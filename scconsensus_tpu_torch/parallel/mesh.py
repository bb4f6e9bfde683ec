"""The device mesh: one process driving one shard per device.

The torch form of ``scconsensus_tpu/parallel/mesh.py``. The reference is
single-controller: one ``refine()`` call in one process lays a
``jax.sharding.Mesh`` over ``jax.devices()`` (:105-112) and runs
``shard_map`` bodies with ``psum`` and ``ppermute``. Here a :class:`Mesh`
is a small frozen object:

  * ``devices``: one ``torch.device`` per shard. Shards may repeat a
    device, the counterpart of the reference's virtual CPU devices: the
    tests run 8 shards on ``cpu``, ``chip_smoke.py`` 4 on one card;
  * ``ids``: shard ids, 0..n-1 on a fresh mesh; they stand in for
    ``jax.Device.id`` in every stamp, and a mesh shrunk by the elastic
    supervisor keeps its survivors' ids;
  * ``axis_name``: ``"cells"``, the reference's ``CELL_AXIS``.

Sharded bodies run in a Python loop over the shards; on several cards
each shard's kernels queue on its own device's current stream, so the
cards overlap with no threads. The collectives are explicit functions on
lists of per-shard tensors: :func:`psum` adds the shard partials in shard
order on shard 0's device, in fp32, and hands the sum to every shard;
:func:`ppermute` rotates the list by one, each block moving to the next
shard's device with ``non_blocking=True`` (a no-op on a shared device).
Sharded results are gathered back onto the device the input lay on
(shard 0's for host input).

Left out against the reference: ``drain_if_cpu_mesh`` (:131), a
workaround for XLA:CPU's collective rendezvous, which a Python loop of
shards cannot deadlock, and ``utils/jax_compat.py``; and the multi-host
form, where one mesh spans processes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import resolve_device

__all__ = [
    "Mesh", "make_mesh", "auto_mesh", "pad_axis_to_multiple",
    "pad_and_shard", "put_sharded", "gather", "psum", "ppermute",
    "require_dense", "require_mesh", "CELL_AXIS", "mesh_shape_meta",
    "mesh_device_ids",
]

CELL_AXIS = "cells"


def _norm_device(device) -> torch.device:
    """A shard's device, checked and with an index on ``cuda`` (so shards
    on "cuda" and "cuda:0" compare equal)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {idx}: "
                             f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", idx)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of shards (see the module docstring)."""

    devices: Tuple[torch.device, ...]
    ids: Tuple[int, ...]
    axis_name: str = CELL_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if len(self.ids) != len(self.devices):
            raise ValueError(f"{len(self.ids)} shard ids for "
                             f"{len(self.devices)} shards")
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(f"shard ids must be distinct, got {self.ids}")
        # a mesh on cuda with no card raises here, before any shard runs
        object.__setattr__(self, "devices",
                           tuple(_norm_device(d) for d in self.devices))
        object.__setattr__(self, "ids", tuple(int(i) for i in self.ids))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        """JAX's platform name for the shards' devices: "gpu" for CUDA."""
        return "gpu" if self.devices[0].type == "cuda" else "cpu"


def require_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is a :class:`Mesh`; TypeError otherwise
    ("auto" is ``refine()``'s policy, not a mesh)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a parallel.mesh.Mesh (or None where the serial "
            f"path exists), got {mesh!r}; refine() alone resolves 'auto'")
    return mesh


def mesh_device_ids(mesh: Optional[Mesh]) -> list:
    """Sorted shard ids of a mesh (``[0]`` for the serial ``None`` path,
    the one-device mesh a mesh run shrinks to)."""
    if mesh is None:
        return [0]
    return sorted(mesh.ids)


def mesh_shape_meta(mesh: Optional[Mesh],
                    axis_name: str = CELL_AXIS) -> dict:
    """The mesh-shape stamp of artifact and checkpoint sidecars, the
    reference's JSON exactly (:35-51), so stores cross between the
    packages. ``None`` stamps the serial path as a one-device shape."""
    if mesh is None:
        from scconsensus_tpu_torch.utils.artifacts import SERIAL_MESH_SHAPE

        return {**SERIAL_MESH_SHAPE, "axis": axis_name}
    return {
        "n_devices": mesh.size,
        "device_ids": mesh_device_ids(mesh),
        "axis": mesh.axis_name or axis_name,
        "platform": mesh.platform,
    }


def auto_mesh(device=None, axis_name: str = CELL_AXIS) -> Optional[Mesh]:
    """The pipeline's mesh policy (:105-112): a mesh over every visible
    card when the run is on ``cuda`` and there are at least two, else None
    (the serial path). ``refine(mesh="auto")`` resolves through this."""
    dev = resolve_device(device)
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return make_mesh(axis_name=axis_name)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CELL_AXIS,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards: over the first ``n_devices`` of
    ``devices`` (default: every visible card), or, when ``device`` is
    given, all on that one device (``n_devices`` default 1), which is how
    the tests and ``chip_smoke.py`` build theirs."""
    if device is not None:
        if devices is not None:
            raise ValueError("pass either devices or device, not both")
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        return Mesh(tuple([_norm_device(device)] * n), tuple(range(n)),
                    axis_name)
    if devices is None:
        resolve_device("cuda")   # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), tuple(range(len(devs))), axis_name)


def require_dense(*arrays) -> None:
    """The mesh engines take dense arrays: reject sparse input (scipy or
    the port's ``DeviceCSR``) with a pointer to the serial engine."""
    from scconsensus_tpu_torch.io.sparsemat import DeviceCSR, is_sparse

    for x in arrays:
        if is_sparse(x) or isinstance(x, DeviceCSR):
            raise TypeError(
                "mesh-parallel entry points require dense arrays; got a "
                "sparse matrix: densify the relevant slice first, or use "
                "the DE engine (de.engine.pairwise_de), which shards "
                "compacted windows of sparse input")


def pad_axis_to_multiple(x, axis: int, multiple: int, fill=0):
    """Pad ``x`` (numpy array or tensor) along ``axis`` up to the next
    multiple. Returns (padded, n_pad)."""
    n = x.shape[axis]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return x, 0
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, n_pad)
        return np.pad(x, widths, constant_values=fill), n_pad
    shape = list(x.shape)
    shape[axis] = n_pad
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis), n_pad


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a numpy array as a host tensor of its dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def put_sharded(x, mesh: Mesh, shard_axis: Optional[int] = None
                ) -> List[torch.Tensor]:
    """``x`` laid out over ``mesh``: one copy per shard when
    ``shard_axis`` is None (replicated), else equal blocks along
    ``shard_axis`` (its length a multiple of the shard count), each on its
    shard's device."""
    t = _as_tensor(x)
    if shard_axis is None:
        return [t.to(d, non_blocking=True) for d in mesh.devices]
    n = t.shape[shard_axis]
    if n % mesh.size:
        raise ValueError(f"axis {shard_axis} of length {n} does not split "
                         f"into {mesh.size} shards")
    return [b.contiguous().to(d, non_blocking=True) for b, d in
            zip(torch.chunk(t, mesh.size, dim=shard_axis), mesh.devices)]


def pad_and_shard(x, mesh: Mesh, shard_axis: int, fill=0
                  ) -> Tuple[List[torch.Tensor], int]:
    """Lay ``x`` out over ``mesh`` in equal blocks along ``shard_axis``,
    padded with ``fill`` up to a multiple of the shard count (:71-103).
    A tensor pads on its own device and each block moves to its shard's;
    a numpy array pads on the host. Returns (blocks, n_pad)."""
    xp, n_pad = pad_axis_to_multiple(x, shard_axis, mesh.size, fill)
    return put_sharded(xp, mesh, shard_axis), n_pad


def gather(blocks: Sequence[torch.Tensor], axis: int = 0,
           device=None) -> torch.Tensor:
    """Concatenate per-shard blocks along ``axis`` on ``device`` (default:
    shard 0's)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks], dim=axis)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """All-reduce: the shard partials added in shard order on shard 0's
    device in fp32, the sum handed to every shard."""
    dev0 = mesh.devices[0]
    total = parts[0].to(device=dev0, dtype=torch.float32)
    for p in parts[1:]:
        total = total + p.to(device=dev0, dtype=torch.float32)
    return [total.to(d, non_blocking=True) for d in mesh.devices]


def ppermute(blocks: Sequence[torch.Tensor], mesh: Mesh
             ) -> List[torch.Tensor]:
    """Ring rotation by one: shard i's block moves to shard i + 1 (mod n),
    the reference's ``perm = [(i, (i + 1) % n)]``."""
    n = mesh.size
    out: List[Optional[torch.Tensor]] = [None] * n
    for i, b in enumerate(blocks):
        j = (i + 1) % n
        out[j] = b.to(mesh.devices[j], non_blocking=True)
    return out
