"""Kernel C's share of its roofline in the window: the bounds of the int8
products of more than 32 rows (every attention, dense and shared-expert
projection of the 40-row verify passes and of the prefills, and the
prefills' per-expert products of the held experts with more than 32 pairs),
from the shapes and the routing the hooks saw, over the device time of
int8_gemm_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline_moe import int8_gemm_bounds


def read(trace):
    return roofline_share(trace, "int8_gemm_kernel",
                          int8_gemm_bounds(trace.records.get("int8_linear", []),
                                           trace.records.get("experts", [])))
