"""Frames whose detections reached the host, over the whole window."""


def read(run):
    r = run.result
    return r["frames"] / r["window_s"] if r.get("window_s") else None
