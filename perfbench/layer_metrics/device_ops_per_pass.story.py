"""Device ops a verify pass: every op on the profiler's device timeline in
the traced parts (their prefills and output-resampler calls included) over
the program's ``decode.pass`` spans of the same parts."""

from perfbench.program_spans import spans


def read(trace):
    passes = len(spans("decode.pass"))
    if not passes:
        return None
    return sum(count for count, _ in trace.kernels.values()) / passes
