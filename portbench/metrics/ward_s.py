"""The ``ward`` spans' seconds per job: Ward.D2 on the host (the native
NN-chain), apart from the pool and its copy to the host, from the jobs'
span records."""

import spantrace


def read(run):
    return spantrace.ward_s(run)
