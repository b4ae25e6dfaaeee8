"""Kernel A's share of its roofline in the window: the bounds of the int8
projections of at most 32 rows (the verify passes' products), from the shapes
the hooks saw, over the device time of int8_linear_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline import int8_linear_bound


def read(trace):
    bounds = [int8_linear_bound(r["m"], r["n"], r["k"])
              for r in trace.records.get("int8_linear", []) if r["m"] <= 32]
    return roofline_share(trace, "int8_linear_kernel", bounds)
