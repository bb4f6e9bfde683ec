"""The window's seconds over the jobs it completed: whole-window
arithmetic, the time to labels of one job run back to back."""

from metrics import ok_jobs


def read(run):
    n = len(ok_jobs(run))
    return run.window_s / n if n and not run.failed else None
