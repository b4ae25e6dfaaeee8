"""The whole step's share of one chip's bf16 peak: the model FLOPs of the
window's work, counted from shapes and the routing (roofline_moe.py; the
routed experts for the pairs held here only), over 989 TFLOP/s times the
traced window."""

from perfbench.harness import mfu


def read(trace):
    return mfu(trace)
