"""``stage_walls_s["tree"]``, per job: the tree stage (exact Ward.D2, or the pool and Ward on its centroids)."""

from metrics import stage_mean


def read(run):
    return stage_mean(run, "tree")
