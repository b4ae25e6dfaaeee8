"""Tokens committed a verify pass a row: the window's generated tokens after
each segment's first (which the prefill picks) over verify passes times
rows."""


def read(trace):
    passes = len(trace.spans.get("llm.verify", []))
    rows = trace.counters.get("rows", 0)
    if not passes or not rows:
        return None
    return trace.counters["decode_tokens"] / (passes * rows)
