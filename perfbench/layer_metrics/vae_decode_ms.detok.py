"""Wall ms a VAE decode of a call's latents to pixels, between CUDA events
recorded by the benchmark's hooks around ``vae.decoder`` (no
synchronization: the span on the device's timeline)."""

from perfbench.harness import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "vae_decode")
