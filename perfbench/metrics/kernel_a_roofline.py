"""Kernel A's share of its roofline in the trace: its least time at each of
the model's sites for the cell's batch (``count/bounds.py``), averaged over
the sites, times its launches in the trace, over its device time there, in
percent."""

from perfbench.count import bounds


def read(run):
    sites = run.count.get("kernel_a_sites")
    if run.summary is None or not sites:
        return None
    seconds, launches = run.summary.kernel_time(bounds.KERNEL_A_NAME)
    if not launches or seconds <= 0:
        return None
    batch = run.traffic["batch"]
    per_launch = sum(bounds.kernel_a_bound_s(rows * batch, d) for rows, d in sites) / len(sites)
    return 100.0 * per_launch * launches / seconds
