"""Frames per replay of the engine's graphs over the window: answers over the
growth of ``InferenceEngine.replays``."""


def read(run):
    r = run.result
    return r["frames"] / r["replays"] if r.get("replays") else None
