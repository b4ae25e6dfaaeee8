"""Host ms of a speculative verify pass of the lockstep batch: the program's
``decode.pass`` spans (the drafts, the verify forward's launches, the copy of
the picks, acceptance), averaged over the traced parts' passes."""

from perfbench.program_spans import mean, spans


def read(trace):
    return mean(r.host_ms() for r in spans("decode.pass"))
