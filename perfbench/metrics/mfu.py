"""The served frames' share of the card's bf16 peak over the window: the
benchmark's own count of a frame's flops (``count/flops.py``) times the
frames, over the window's seconds and 989 TFLOP/s, in percent."""

from perfbench.count import bounds


def read(run):
    r = run.result
    if not r.get("window_s") or not r.get("frames"):
        return None
    return 100.0 * run.count["frame_flops"] * r["frames"] / r["window_s"] / bounds.PEAK_BF16_FLOPS
