"""Percent of the traced stretch of training with nothing running on the
card (the union of its device events' intervals, the pad dropped)."""
from perfbench import trace


def read(run):
    return trace.idle_share(run.trace)
