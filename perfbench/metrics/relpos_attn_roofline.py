"""The relative-position attention kernel's share of its roofline in the
trace, as ``kernel_a_roofline`` reads kernel A: its least time at each of a
forward's attention sites for the cell's batch (``count/attention.py``),
averaged over the sites, times its launches in the trace, over its device
time there, in percent."""

from perfbench.count import attention


def read(run):
    if run.summary is None or "window_block_indexes" not in run.cfg:
        return None
    seconds, launches = run.summary.kernel_time(attention.KERNEL_NAME)
    if not launches or seconds <= 0:
        return None
    sites = attention.sites(run.cfg, run.traffic["image_size"])
    batch = run.traffic["batch"]
    per_launch = sum(attention.bound_s(s, batch) for s in sites) / len(sites)
    return 100.0 * per_launch * launches / seconds
