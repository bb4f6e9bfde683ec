"""Calls per job that make the host wait on the card without a stage
drain: ``cudaStreamSynchronize``, ``cudaEventSynchronize`` and
synchronous ``cudaMemcpy*`` inside the ``consensus`` and
``portbench.refine`` windows (``spantrace``)."""

import spantrace


def read(run):
    s = spantrace.of(run)
    return s["implicit_syncs"] if s else None
