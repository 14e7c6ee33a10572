"""Helpers the metric readers share."""

from __future__ import annotations


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def idle_share(run):
    """Percent of the traced window in which no operation ran on the
    device; None without a trace or with no device operation in it."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
