"""The whole step's share of one chip's bf16 peak: the model FLOPs of the
window's work, counted from shapes by roofline.py or torch's FLOP counter,
over 989 TFLOP/s times the traced window."""

from perfbench.harness import mfu


def read(trace):
    return mfu(trace)
