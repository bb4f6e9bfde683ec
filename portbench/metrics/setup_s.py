"""Set-up: from the start of the process to the first timed job (torch
and CUDA, the program's native builds when not yet built, the inputs
drawn on the card, one warm job)."""


def read(run):
    return run.setup_s
