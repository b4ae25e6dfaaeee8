"""The flash forward's share of its roofline in the de-tokenizer's window:
the bound of each UNet attention (self-attention at both latent sizes,
cross-attention onto the conditioning) from its shapes, over the device time
of flash_fwd_kernel."""

from perfbench.harness import roofline_share
from perfbench.roofline import attention_work, flash_fwd_bound


def read(trace):
    bounds = [flash_fwd_bound(attention_work(r["b"], r["h"], r["h"], r["lq"], r["lk"], r["d"],
                                             False))
              for r in trace.records.get("flash_fwd", [])]
    return roofline_share(trace, "flash_fwd_kernel", bounds)
