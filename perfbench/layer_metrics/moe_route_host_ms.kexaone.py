"""Host ms a verify pass spends routing: the program's ``moe.route`` spans
(router, top-k and the dispatch's sort, every expert layer) summed under
each ``decode.verify``, averaged over the passes."""

from perfbench.program_spans import mean, with_children


def read(trace):
    return mean(ms for _, ms in with_children("decode.verify", "moe.route"))
