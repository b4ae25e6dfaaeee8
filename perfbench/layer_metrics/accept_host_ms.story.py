"""Host ms a verify pass spends on the drafts and on acceptance: the
program's ``decode.draft`` and ``decode.accept`` spans (prompt-lookup drafts
and the block; accept, EOS, the per-row token and hidden writes, the cache
lengths), summed under each ``decode.pass`` and averaged over the passes."""

from perfbench.program_spans import mean, with_children


def read(trace):
    return mean(ms for _, ms in with_children("decode.pass", "decode.draft", "decode.accept"))
