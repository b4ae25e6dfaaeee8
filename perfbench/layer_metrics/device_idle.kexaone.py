"""Percent of the traced window in which no operation ran on the device
(from the profiler's device timeline)."""

from perfbench.harness import idle_share


def read(trace):
    return idle_share(trace)
