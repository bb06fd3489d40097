"""The relative-position attention kernel's device milliseconds in the
trace over the batches dispatched in it (the program's ``engine.dispatch``
spans)."""

from perfbench.count import attention
from perfbench.harness import program_spans


def read(run):
    if run.summary is None:
        return None
    seconds, launches = run.summary.kernel_time(attention.KERNEL_NAME)
    batches = program_spans.named(run, "engine.dispatch")
    if not launches or not batches:
        return None
    return seconds / len(batches) * 1e3
