"""The ``consensus`` spans' seconds per job: ``plot_contingency_table``'s
table and automated consensus, read from their profiler windows
(``spantrace``)."""

import spantrace


def read(run):
    s = spantrace.of(run)
    return s["consensus_s"] if s else None
