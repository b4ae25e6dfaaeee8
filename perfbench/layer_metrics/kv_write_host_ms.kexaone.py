"""Host ms a verify pass spends writing the new K/V rows into the int8 cache
(the quantize and the per-row slice writes of every layer): the program's
``llm.kv_write`` spans summed under each ``decode.verify``, averaged over the
passes."""

from perfbench.program_spans import mean, with_children


def read(trace):
    return mean(ms for _, ms in with_children("decode.verify", "llm.kv_write"))
