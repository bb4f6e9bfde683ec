"""Seconds per job inside the ``de`` window in which no kernel, copy or
memset ran on the card (``spantrace``)."""

import spantrace


def read(run):
    s = spantrace.of(run)
    return s["de_idle_s"] if s else None
