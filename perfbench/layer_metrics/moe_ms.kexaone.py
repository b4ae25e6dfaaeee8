"""Device ms a verify pass spends in the mixture-of-experts modules (router,
dispatch, routed and shared experts, combine): the benchmark's hooks time
each expert layer's call in a verify pass between CUDA events; their sum
over the window, over the number of verify passes."""


def read(trace):
    calls = trace.spans.get("moe.verify", [])
    passes = len(trace.spans.get("llm.verify", []))
    return sum(ms for ms, _ in calls) / passes if calls and passes else None
