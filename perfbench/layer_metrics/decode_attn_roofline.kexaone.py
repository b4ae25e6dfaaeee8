"""Kernel B's share of its roofline in the window, window-aware: the bound
of each small-query cache attention (every layer of every verify pass) from
its rows' fill levels and the layer's window (a windowed layer's queries see
at most 128 keys), over the device time of decode_attn_chunk_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline_moe import decode_attn_window_bound


def read(trace):
    bounds = [decode_attn_window_bound(r["b"], r["hq"], r["hkv"], r["s"], r["d"], r["starts"],
                                       r["window"], r["bytes"])
              for r in trace.records.get("decode_attn", [])]
    return roofline_share(trace, "decode_attn_chunk_kernel", bounds)
