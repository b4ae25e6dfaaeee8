"""Wall ms a UNet call over the uncond / cond pair of every image of a call,
between CUDA events recorded by the benchmark's hooks (no synchronization:
the span on the device's timeline)."""

from perfbench.harness import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "unet")
