"""The grouped int8 expert kernel's share of its roofline in the window: the
bound of each launch (gate and up, then down, every expert layer of every
verify pass) from the experts some pair hit and the pairs the dispatch
listed, over the device time of grouped_int8_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline_moe import grouped_launch_bounds


def read(trace):
    return roofline_share(trace, "grouped_int8_kernel",
                          grouped_launch_bounds(trace.records.get("experts", [])))
