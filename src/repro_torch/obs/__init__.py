"""Streaming metrics for the control plane: counters, gauges and
fixed-bucket log histograms in a :class:`MetricsRegistry`.

The port's copy of the JAX package's ``obs/metrics.py``.  The flight
recorder (``obs/{trace,decode,export}.py``, the live plane's
``trace=True``) is not ported yet (ROADMAP queue 1, item 13).
"""
from .metrics import (Counter, Gauge, LogHistogram, MetricsRegistry,
                      MetricsSnapshot)

__all__ = ["Counter", "Gauge", "LogHistogram", "MetricsRegistry",
           "MetricsSnapshot"]
