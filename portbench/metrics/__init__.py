"""Metric readers, one module a metric, named after it.

Each module has ``read(run) -> float | None``: ``run`` is ``run.Run``
(its ``jobs`` records, ``setup_s``, ``window_s``, ``peak_bytes`` and, in a
traced run, ``trace``, the summary of ``devtrace.summarize``). A reader
that finds nothing to read returns None and the metric is left out of
the result line. Stage walls are the program's own ``stage_walls_s``
(the card is drained at every stage boundary), summed over the window's
jobs and divided by the jobs.
"""

from typing import Optional

TOP_STAGES = ("de", "de_store", "union", "embed", "tree", "cuts",
              "silhouette", "nodg", "quality", "report")


def ok_jobs(run):
    return [j for j in run.jobs if "error" not in j]


def stage_mean(run, *names) -> Optional[float]:
    jobs = ok_jobs(run)
    if not jobs or not any(n in j["stage_walls_s"] for j in jobs
                           for n in names):
        return None
    return sum(sum(j["stage_walls_s"].get(n, 0.0) for n in names)
               for j in jobs) / len(jobs)
