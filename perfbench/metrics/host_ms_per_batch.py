"""Host milliseconds per batch in the engine's entry points: the benchmark's
spans around ``dispatch_batch`` (staging into the pinned ring, the replay's
enqueue) and ``finalize_batch`` (unpacking, each frame's host postprocess;
the wait for the copy-out is a span of its own before it), summed and
divided by the window's batches."""


def read(run):
    spans = run.spans.spans
    batches = len(spans.get("finalize", ()))
    if not batches:
        return None
    total = sum(e - s for name in ("dispatch", "finalize") for s, e in spans.get(name, ()))
    return total / batches * 1e3
