"""The distance × cluster-sum kernel's share of its roofline: the least
time of every launch's shapes (``roofline.dcs_counts`` at the card's
peaks) over the device time of the launches' four kernels in the trace,
summed over the window."""

import re

from metrics import ok_jobs
from roofline import dcs_counts, least_seconds

# the launch's four __global__ functions, as the profiler names them
# (torch's own at::native::reduce_kernel must not match)
KERNELS = re.compile(r"^(void\s+)?(\(anonymous namespace\)::)?"
                     r"(sweep|reduce|prepare|keys)_kernel\b")


def read(run):
    if not run.trace:
        return None
    shapes = [j["dcs"] for j in ok_jobs(run) if j.get("dcs")]
    spent = sum(s for name, s in run.trace["kernel_s"].items()
                if KERNELS.match(name))
    if not shapes or spent <= 0:
        return None
    least = sum(least_seconds(*dcs_counts(**s)) for s in shapes)
    return 100.0 * least / spent
