"""The device mesh: one shard per device, in one process or across several.

The torch form of ``scconsensus_tpu/parallel/mesh.py``. The reference is
single-controller: one ``refine()`` call in each process lays a
``jax.sharding.Mesh`` over ``jax.devices()`` (:105-112) and runs
``shard_map`` bodies with ``psum`` and ``ppermute``; under
``jax.distributed`` the same mesh spans processes, each holding only its
addressable shards (``tests/multihost_worker.py``). Here a :class:`Mesh`
is a small frozen object:

  * ``devices``: one ``torch.device`` per shard. Shards may repeat a
    device, the counterpart of the reference's virtual CPU devices: the
    tests run 8 shards on ``cpu``, ``chip_smoke.py`` 4 on one card;
  * ``ids``: shard ids, 0..n-1 on a fresh mesh; they stand in for
    ``jax.Device.id`` in every stamp, and a mesh shrunk by the elastic
    supervisor keeps its survivors' ids;
  * ``axis_name``: ``"cells"``, the reference's ``CELL_AXIS``;
  * ``procs`` and ``rank``: the processes the shards are split across
    and this one's rank (1 and 0 in one process).

Sharded bodies run in a Python loop over this process's shards; on
several cards each shard's kernels queue on its own device's current
stream, so the cards overlap with no threads. The collectives are
explicit functions on lists of this process's per-shard tensors:
:func:`psum` adds the shard partials in shard order on the local device,
in fp32, and hands the sum to every shard; :func:`ppermute` rotates the
blocks by one shard, each moving to the next shard's device with
``non_blocking=True`` (a no-op on a shared device); :func:`gather`
concatenates the blocks in shard order. Sharded results are gathered back
onto the device the input lay on (for host input, :attr:`Mesh.home`,
shard 0's in one process).

**Across processes.** Once ``torch.distributed`` is initialized with
more than one rank, a mesh spans every rank's devices, as the
reference's ``jax.devices()`` spans every process's. A rank's visible
devices are every card it sees, in index order, on ``cuda`` (JAX's
``local_devices``) and one device on the CPU (JAX's default of one CPU
device a process; under a launcher that does not narrow
``CUDA_VISIBLE_DEVICES`` to one card a rank, every rank of a node with
several cards drives all of them and homes on ``cuda:0``); the global
list joins the ranks' lists in rank order
(an ``all_gather_object`` when the mesh is built, so every rank builds
its meshes in the same order). ``auto_mesh`` lays a mesh over that list,
``make_mesh(n)`` over its first ``n`` entries and
``make_mesh(devices=...)`` over each rank's own list joined in rank
order. Unlike the reference, whose mesh may hold shards some process
cannot address, a :class:`Mesh` needs the same number of shards on every
rank, rank r holding a contiguous block: a list that breaks this raises
``ValueError``. ``make_mesh(n, device=...)`` splits ``n`` shards of each
rank's one device evenly across the ranks. On every form rank r holds
shards ``r·n/R .. (r+1)·n/R − 1`` and computes only those; the other
ranks' entries of ``devices`` are names, never touched here. ``size``,
``ids`` and ``mesh_shape_meta`` stay global, so stamps and stores are
those of a one-process mesh of ``n`` shards. :func:`put_sharded` and
:func:`pad_and_shard` take the same host value in every process and keep
the local blocks (the reference's ``put_sharded`` contract);
:func:`require_same_on_every_rank` is how ``refine()`` refuses ranks that
pass different inputs. The
collectives cross the process group (the default group) over gloo with
host-staged tensors, on the CPU and on the card alike (NCCL cannot run
two ranks on one device): :func:`psum` gathers every shard's partial to
every rank and adds them in shard order, so it gives the one-process
bits; :func:`ppermute` rotates locally and sends only the boundary block
to the next rank; :func:`gather` returns the full result on every rank,
so each goes on with the host tree and the cut as in one process.
:data:`SENT_BYTES` counts what this rank sent across the group, by
collective. A device loss on such a mesh is ``robust.elastic``'s.

:func:`drain_if_cpu_mesh` keeps the reference's signature (:131); a
Python loop of shards cannot deadlock as XLA:CPU's collective rendezvous
can, so it only waits for the arrays. ``utils/jax_compat.py`` has no
port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from scconsensus_tpu_torch.device import resolve_device

__all__ = [
    "Mesh", "make_mesh", "auto_mesh", "drain_if_cpu_mesh",
    "pad_axis_to_multiple",
    "pad_and_shard", "put_sharded", "gather", "psum", "ppermute",
    "require_dense", "require_mesh", "CELL_AXIS", "mesh_shape_meta",
    "mesh_device_ids", "SENT_BYTES", "require_same_on_every_rank",
]

CELL_AXIS = "cells"

# bytes this process sent across the process group, by collective (a
# multi-process mesh's; reset by the caller)
SENT_BYTES = {"psum": 0, "ppermute": 0, "gather": 0}


def _group_world() -> Tuple[int, int]:
    """(world size, rank) of an initialized ``torch.distributed`` default
    group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


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
    procs: int = 1
    rank: int = 0

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if self.procs < 1 or not 0 <= self.rank < self.procs or \
                len(self.devices) % self.procs:
            raise ValueError(f"{len(self.devices)} shards do not split "
                             f"evenly across {self.procs} processes "
                             f"(rank {self.rank})")
        if len(self.ids) != len(self.devices):
            raise ValueError(f"{len(self.ids)} shard ids for "
                             f"{len(self.devices)} shards")
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(f"shard ids must be distinct, got {self.ids}")
        # a mesh on cuda with no card raises here, before any shard runs;
        # another rank's entries are names, checked on that rank
        local = self.local
        object.__setattr__(self, "devices", tuple(
            _norm_device(d) if i in local else torch.device(d)
            for i, d in enumerate(self.devices)))
        object.__setattr__(self, "ids", tuple(int(i) for i in self.ids))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """The positions of this process's shards (all of them in one
        process)."""
        n = self.size // self.procs
        return range(self.rank * n, (self.rank + 1) * n)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard (shard 0's in one
        process): where host input to a sharded call lands and where its
        gathered result stays."""
        return self.devices[self.local[0]]

    @property
    def platform(self) -> str:
        """JAX's platform name for the shards' devices: "gpu" for CUDA."""
        return "gpu" if self.home.type == "cuda" else "cpu"


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


def require_same_on_every_rank(mesh: Optional[Mesh], value,
                               what: str = "input") -> None:
    """``ValueError`` on every rank unless every rank of a mesh across
    processes passed an equal ``value`` (a fingerprint of its input): a
    mesh run is one program over one input, and ranks that each run their
    own would have the shards mix their data. A collective across the
    mesh's ranks; a no-op on a one-process mesh or None."""
    if mesh is None or mesh.procs == 1:
        return
    import torch.distributed as dist

    got: List[object] = [None] * mesh.procs
    dist.all_gather_object(got, value)
    differ = [r for r, v in enumerate(got) if v != got[0]]
    if differ:
        raise ValueError(
            f"a mesh across {mesh.procs} processes runs one {what} on "
            f"every rank, but ranks {differ} passed another {what} than "
            f"rank 0 ({got[0]!r} on rank 0, {got[differ[0]]!r} on rank "
            f"{differ[0]})")


def _visible_devices(device_type: str) -> List[torch.device]:
    """This process's devices of one type: every card it sees, in index
    order, on ``cuda`` (raises without one); one device on the CPU."""
    if device_type == "cuda":
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _joined(local: Sequence) -> Tuple[List[torch.device], List[int]]:
    """Every rank's device list joined in rank order (the order of
    ``jax.devices()``), and the rank of each entry. A collective across
    an initialized group of more than one rank; this list alone
    otherwise."""
    local = [_norm_device(d) for d in local]
    world, rank = _group_world()
    if world == 1:
        return local, [0] * len(local)
    import torch.distributed as dist

    lists: List[Optional[list]] = [None] * world
    dist.all_gather_object(lists, [str(d) for d in local])
    devs: List[torch.device] = []
    owners: List[int] = []
    for r, names in enumerate(lists):
        devs += local if r == rank else [torch.device(n) for n in names]
        owners += [r] * len(names)
    return devs, owners


def _global_mesh(devs: List[torch.device], owners: List[int],
                 n_devices: Optional[int], axis_name: str) -> Mesh:
    """A mesh over the first ``n_devices`` (default all) of a joined
    list; ValueError unless every rank holds the same number of them."""
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs, owners = devs[:n_devices], owners[:n_devices]
    world, rank = _group_world()
    counts = [owners.count(r) for r in range(world)]
    if len(set(counts)) != 1:
        raise ValueError(
            f"a mesh across {world} processes needs the same number of "
            f"shards on every rank, rank r holding a contiguous block; "
            f"these {len(devs)} devices give the ranks {counts} (the "
            "reference would build a mesh some process cannot address)")
    return Mesh(tuple(devs), tuple(range(len(devs))), axis_name,
                procs=world, rank=rank)


def auto_mesh(device=None, axis_name: str = CELL_AXIS) -> Optional[Mesh]:
    """The pipeline's mesh policy (:105-112): a mesh over every rank's
    visible devices of ``device``'s type (every card on ``cuda``, one
    device on the CPU; in rank order across an initialized group) when
    there are at least two, else None (the serial path).
    ``refine(mesh="auto")`` resolves through this: serial on one card or
    the CPU in one process, one shard a rank on the CPU across ranks."""
    dev = resolve_device(device)
    devs, owners = _joined(_visible_devices(dev.type))
    if len(devs) < 2:
        return None
    return _global_mesh(devs, owners, None, axis_name)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CELL_AXIS,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards over the first ``n_devices`` of the
    global device list (default: all of it): every rank's ``devices``
    (default: every card it sees) joined in rank order (:115-128). With
    ``device``, all ``n_devices`` shards (default 1) lie on that one
    device, split evenly across the ranks of an initialized group (each
    rank passes its own device), which is how the tests and
    ``chip_smoke.py`` build theirs. Across ranks every rank must hold the
    same number of shards (``ValueError`` otherwise)."""
    if device is not None:
        if devices is not None:
            raise ValueError("pass either devices or device, not both")
        world, rank = _group_world()
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        if n % world:
            raise ValueError(f"{n} shards do not split evenly across "
                             f"{world} processes")
        return Mesh(tuple([_norm_device(device)] * n), tuple(range(n)),
                    axis_name, procs=world, rank=rank)
    devs, owners = _joined(_visible_devices("cuda") if devices is None
                           else list(devices))
    return _global_mesh(devs, owners, n_devices, axis_name)


def drain_if_cpu_mesh(mesh: Mesh, *arrays) -> None:
    """The reference's wait after a sharded launch (:131): it blocks until
    ``arrays`` are ready on a CPU mesh, where XLA's in-process collectives
    can deadlock with several programs in flight. Here it waits on the
    cards the arrays (tensors, or lists and tuples of them) lie on; on a
    CPU mesh, whose shard loop cannot deadlock and whose tensors are
    ready when their operators return, it is a no-op."""
    require_mesh(mesh)
    cards = set()
    todo = list(arrays)
    while todo:
        a = todo.pop()
        if isinstance(a, (list, tuple)):
            todo += a
        elif isinstance(a, torch.Tensor) and a.device.type == "cuda":
            cards.add(a.device)
    for d in cards:
        torch.cuda.synchronize(d)


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
    shard's device. Only this process's shards: every process passes the
    same value and keeps its own blocks."""
    t = _as_tensor(x)
    local = mesh.local
    if shard_axis is None:
        return [t.to(mesh.devices[i], non_blocking=True) for i in local]
    n = t.shape[shard_axis]
    if n % mesh.size:
        raise ValueError(f"axis {shard_axis} of length {n} does not split "
                         f"into {mesh.size} shards")
    blocks = torch.chunk(t, mesh.size, dim=shard_axis)
    return [blocks[i].contiguous().to(mesh.devices[i], non_blocking=True)
            for i in local]


def pad_and_shard(x, mesh: Mesh, shard_axis: int, fill=0
                  ) -> Tuple[List[torch.Tensor], int]:
    """Lay ``x`` out over ``mesh`` in equal blocks along ``shard_axis``,
    padded with ``fill`` up to a multiple of the shard count (:71-103).
    A tensor pads on its own device and each block moves to its shard's;
    a numpy array pads on the host. Returns (blocks, n_pad)."""
    xp, n_pad = pad_axis_to_multiple(x, shard_axis, mesh.size, fill)
    return put_sharded(xp, mesh, shard_axis), n_pad


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy for gloo (the tensor itself on the CPU)."""
    return t.detach().to("cpu").contiguous()


def _all_gather(local: torch.Tensor, mesh: Mesh, name: str
                ) -> List[torch.Tensor]:
    """Every rank's ``local`` (host-staged, any shape), in rank order."""
    import torch.distributed as dist

    h = _host(local)
    shapes: List[Optional[list]] = [None] * mesh.procs
    dist.all_gather_object(shapes, list(h.shape))
    size = max(int(np.prod(sh)) for sh in shapes)
    flat = torch.zeros(size, dtype=h.dtype)
    flat[:h.numel()] = h.reshape(-1)
    got = [torch.empty(size, dtype=h.dtype) for _ in range(mesh.procs)]
    dist.all_gather(got, flat)
    SENT_BYTES[name] += h.numel() * h.element_size() * (mesh.procs - 1)
    return [g[:int(np.prod(sh))].reshape(sh)
            for g, sh in zip(got, shapes)]


def gather(blocks: Sequence[torch.Tensor], axis: int = 0,
           device=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Concatenate per-shard blocks along ``axis`` on ``device`` (default:
    shard 0's). On a ``mesh`` that spans processes, ``blocks`` are this
    process's and every rank's are gathered in shard order: each rank
    gets the full result."""
    dev = blocks[0].device if device is None else torch.device(device)
    local = torch.cat([b.to(dev) for b in blocks], dim=axis)
    if mesh is None or mesh.procs == 1:
        return local
    parts = _all_gather(local, mesh, "gather")
    return torch.cat([p.to(dev) for p in parts], dim=axis)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """All-reduce: the shard partials added in shard order on the local
    shards' device in fp32, the sum handed to each of this process's
    shards. Across processes every shard's partial reaches every rank
    first, so the additions and their order are the one-process mesh's."""
    dev0 = mesh.devices[mesh.local[0]]
    parts = [p.to(device=dev0, dtype=torch.float32) for p in parts]
    if mesh.procs > 1:
        if len({tuple(p.shape) for p in parts}) != 1:
            raise ValueError("psum partials must share one shape")
        stacked = _all_gather(torch.stack(parts), mesh, "psum")
        parts = [p.to(dev0) for g in stacked for p in g.unbind(0)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return [total.to(mesh.devices[i], non_blocking=True)
            for i in mesh.local]


def ppermute(blocks: Sequence[torch.Tensor], mesh: Mesh
             ) -> List[torch.Tensor]:
    """Ring rotation by one: shard i's block moves to shard i + 1 (mod n),
    the reference's ``perm = [(i, (i + 1) % n)]``. Across processes this
    process's last block goes to the next rank and its first shard takes
    the previous rank's last block (``isend``/``irecv``, host-staged);
    the other moves stay local."""
    local = mesh.local
    out: List[Optional[torch.Tensor]] = [None] * len(local)
    for k in range(len(local) - 1):
        out[k + 1] = blocks[k].to(mesh.devices[local[k + 1]],
                                  non_blocking=True)
    if mesh.procs == 1:
        out[0] = blocks[-1].to(mesh.devices[local[0]], non_blocking=True)
        return out
    import torch.distributed as dist

    send = _host(blocks[-1])
    recv = torch.empty_like(send)
    reqs = [dist.isend(send, (mesh.rank + 1) % mesh.procs),
            dist.irecv(recv, (mesh.rank - 1) % mesh.procs)]
    for r in reqs:
        r.wait()
    SENT_BYTES["ppermute"] += send.numel() * send.element_size()
    out[0] = recv.to(mesh.devices[local[0]])
    return out
