"""Kernel B's share of its roofline in the window: the bound of each
small-query cache attention (every layer of every verify pass) from its rows'
fill levels, over the device time of decode_attn_chunk_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline import decode_attn_bound


def read(trace):
    bounds = [decode_attn_bound(r["b"], r["hq"], r["hkv"], r["s"], r["d"], r["starts"],
                                [st + r["s"] for st in r["starts"]], r["bytes"])
              for r in trace.records.get("decode_attn", [])]
    return roofline_share(trace, "decode_attn_chunk_kernel", bounds)
