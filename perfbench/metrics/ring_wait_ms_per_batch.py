"""Host milliseconds per batch in the engine's ``engine.ring_wait`` span: the
wait for the pinned ring's slot, until the copy that last read it ended."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "engine.ring_wait")
