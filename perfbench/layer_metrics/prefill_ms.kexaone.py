"""Wall ms a batched prefill (a K-EXAONE forward over the right-padded
prompts of a round), between CUDA events recorded by the benchmark's
hooks."""

from perfbench.harness import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "llm.prefill")
