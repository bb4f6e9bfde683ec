"""Declared host↔device crossings and their listeners.

A small counterpart of ``scconsensus_tpu/obs/residency.py:218-235,302``.
The reference audits every JAX transfer through a transfer guard; the
port's crossings are explicit ``.cpu()`` and ``.to(device)`` copies, so
the code that makes one declares it: inside ``boundary(name)`` it calls
``note_transfer(direction, nbytes)``, and every registered listener
receives ``(direction, nbytes, boundary)``. The streaming layer's budget
accountant listens, which gives it the reference's
``transfers_by_boundary`` evidence. With no listener a note is one list
check.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, List, Optional

__all__ = ["BOUNDARIES", "boundary", "current_boundary", "note_transfer",
           "add_transfer_listener", "remove_transfer_listener"]

# the crossings the port declares (names as in the reference's allowlist)
BOUNDARIES = frozenset({
    "input_staging",        # a chunk slab's upload
    "stream_block_fetch",   # a chunk's (P, Gb) log p and U to the host
    "embed_scores_fetch",   # the (N, n_pcs) scores to the host
})

_TLS = threading.local()
_LISTENERS: List[Any] = []


def add_transfer_listener(fn) -> None:
    """Register ``fn(direction, nbytes, boundary)``; idempotent."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def remove_transfer_listener(fn) -> None:
    try:
        _LISTENERS.remove(fn)
    except ValueError:
        pass


def current_boundary() -> Optional[str]:
    return getattr(_TLS, "name", None)


@contextmanager
def boundary(name: str):
    """Declare an intentional crossing scope; ``name`` must be in
    :data:`BOUNDARIES` (KeyError otherwise, as in the reference)."""
    if name not in BOUNDARIES:
        raise KeyError(f"undeclared residency boundary {name!r}; "
                       f"declared: {sorted(BOUNDARIES)}")
    prev = getattr(_TLS, "name", None)
    _TLS.name = name
    try:
        yield
    finally:
        _TLS.name = prev


def note_transfer(direction: str, nbytes: int) -> None:
    """Record one crossing (``"h2d"`` or ``"d2h"``) of ``nbytes`` under
    the enclosing boundary. A crossing between two host tensors (the CPU
    runs) moves nothing and is not noted by its callers."""
    if not _LISTENERS:
        return
    name = current_boundary()
    for fn in list(_LISTENERS):
        fn(direction, int(nbytes), name)
