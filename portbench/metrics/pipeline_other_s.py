"""A job's wall on the benchmark's clock less the program's top-level
stage walls: the consensus, the entry point's own work between stages
and the return, per job."""

from metrics import TOP_STAGES, ok_jobs


def read(run):
    jobs = ok_jobs(run)
    if not jobs:
        return None
    return sum(j["wall_s"] - sum(j["stage_walls_s"].get(s, 0.0)
                                 for s in TOP_STAGES)
               for j in jobs) / len(jobs)
