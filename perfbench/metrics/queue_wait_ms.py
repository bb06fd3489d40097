"""95th percentile (nearest rank) of the window's requests' queue waits: the
engine's ``request.queued`` spans, from ``submit`` to the start of the
dispatch of the batch that took the request."""

import math

from perfbench.harness import program_spans


def read(run):
    queued = program_spans.named(run, "request.queued")
    if queued is None:
        return None
    ordered = sorted(e - s for _, s, e, *_ in queued)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] / 1e6
