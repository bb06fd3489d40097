"""Share of the traced window, in percent, in which the card was idle (no
kernel, copy or set ran) while some request had been submitted and its
batch's ``engine.launch`` had not yet ended: the card's idle time in which
the host held frames it had. Read beside ``idle_share``."""

from perfbench.harness import program_spans


def read(run):
    queued = program_spans.named(run, "request.queued")
    window = program_spans.window_ns(run)
    if queued is None or window is None or window[1] <= window[0]:
        return None
    busy = program_spans.device_busy(run)
    if not busy:
        return None
    launched = {parent: end for name, _, end, _, parent, _ in program_spans.spans(run)
                if name == "engine.launch"}
    lo, hi = window
    held = program_spans.union((max(s, lo), min(launched[batch], hi))
                               for _, s, _, _, batch, _ in queued
                               if batch in launched and s < hi and launched[batch] > lo)
    held_s = sum(e - s for s, e in held)
    idle_held = held_s - program_spans.overlap(held, busy)
    return 100.0 * idle_held / (hi - lo)
