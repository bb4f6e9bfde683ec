"""``stage_walls_s["de"]``, per job: the DE stage (filter, aggregates, gates, the test, BH, the call)."""

from metrics import stage_mean


def read(run):
    return stage_mean(run, "de")
