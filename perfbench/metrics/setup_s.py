"""Seconds from the process's start to the window's first frame: imports,
the inputs made from the seed, the program's load, its kernels built or
loaded, its graphs captured, the untimed batches. The benchmark's own
reference work before the window (``Run.reference_time``) is left out."""


def read(run):
    return run.setup_s
