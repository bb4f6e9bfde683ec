"""``stage_walls_s["cuts"]``, per job: the dynamic tree cut of every deepSplit."""

from metrics import stage_mean


def read(run):
    return stage_mean(run, "cuts")
