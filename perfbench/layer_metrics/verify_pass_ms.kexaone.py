"""Wall ms a speculative verify pass of the 8-story batch: the device
timeline of each LLaMA forward over a (B, K + 1) block, between CUDA events
recorded by the benchmark's hooks, averaged over every pass in the window."""

from perfbench.harness import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "llm.verify")
