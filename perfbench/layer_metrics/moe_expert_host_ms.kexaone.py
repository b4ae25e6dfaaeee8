"""Host ms a verify pass spends enqueueing the routed experts: the program's
``moe.experts`` spans (the grouped launches and the combine, every expert
layer) summed under each ``decode.verify``, averaged over the passes."""

from perfbench.program_spans import mean, with_children


def read(trace):
    return mean(ms for _, ms in with_children("decode.verify", "moe.experts"))
