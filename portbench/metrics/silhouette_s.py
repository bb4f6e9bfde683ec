"""``stage_walls_s["silhouette"]``, per job: the silhouettes of every cut."""

from metrics import stage_mean


def read(run):
    return stage_mean(run, "silhouette")
