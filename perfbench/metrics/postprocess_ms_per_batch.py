"""Host milliseconds per batch in the engine's ``engine.postprocess`` span:
the packed output unpacked and each frame's detections mapped back to its
pixels and filtered, after the copy-out's wait."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "engine.postprocess")
