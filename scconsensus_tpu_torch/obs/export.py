"""Atomic file writes: the one primitive every artifact writer shares.

The port's copy of ``ATOMIC_TMP_PREFIX``, ``atomic_write`` and
``write_json_atomic`` from ``scconsensus_tpu/obs/export.py:603-653``;
nothing else of that module is ported.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

__all__ = ["ATOMIC_TMP_PREFIX", "atomic_write", "write_json_atomic"]

ATOMIC_TMP_PREFIX = ".scc-tmp-"


def atomic_write(path: str, write_fn, inspect_fn=None) -> None:
    """``write_fn(tmp_path)`` produces the full content at a unique temp
    path in the destination dir (same filesystem, so ``os.replace`` is
    atomic), the temp file is fsynced, then renamed over the destination.
    An interrupted writer can leave a stale ``.scc-tmp-*`` file but never a
    truncated artifact under a real name.

    ``inspect_fn(tmp_path)``, when given, runs between the write and the
    replace, for work that must see the final bytes before they land under
    the real name (the artifact store checksums the arrays file here and
    writes its sidecar). A raising inspect_fn aborts the write and cleans
    up the temp."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=ATOMIC_TMP_PREFIX, dir=d)
    os.close(fd)
    try:
        # mkstemp creates 0600; restore the umask-default mode so shared
        # artifact dirs can read the renamed file
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        write_fn(tmp)
        if inspect_fn is not None:
            inspect_fn(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json_atomic(path: str, obj: Any, indent: int = 1) -> None:
    """Atomic JSON export (see :func:`atomic_write`)."""
    def _w(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=str)

    atomic_write(path, _w)
