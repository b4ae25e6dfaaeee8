"""Host ms a verify pass spends enqueueing its device work: the program's
``decode.verify`` span (embedding, the LLaMA forward, the automaton, the
argmax, up to the copy of the picks) less its ``llm.kv_write`` children,
averaged over the passes."""

from perfbench.program_spans import mean, with_children


def read(trace):
    return mean(r.host_ms() - ms for r, ms in with_children("decode.verify", "llm.kv_write"))
