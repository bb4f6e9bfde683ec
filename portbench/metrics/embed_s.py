"""``stage_walls_s["union"] + ["embed"]``, per job: the DE-gene union and
the PCA embedding."""

from metrics import stage_mean


def read(run):
    return stage_mean(run, "union", "embed")
