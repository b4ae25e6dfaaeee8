"""Host ms a verify pass waits for the device: the program's ``decode.sync``
span (the device-to-host copy of the picks, which waits for the pass's
device work), averaged over the passes."""

from perfbench.program_spans import mean, spans


def read(trace):
    return mean(r.host_ms() for r in spans("decode.sync"))
