"""Kernels per job whose launch, matched by ``correlation`` id, lies
inside the ``de`` window (``spantrace``)."""

import spantrace


def read(run):
    s = spantrace.of(run)
    return s["de_launches"] if s else None
