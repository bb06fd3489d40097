"""Host milliseconds per batch in the engine's ``engine.stage`` span: the
frames copied into the pinned ring and the copy to the card enqueued."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "engine.stage")
