"""repro_torch.obs — structured telemetry (spans, counters, Perfetto export).

The JAX package's `obs`, ported whole: the same names, event layout,
profile file and CLI.  Quick start::

    from repro_torch import obs

    with obs.scoped() as col:
        with obs.span("my.phase", lane="main", k=3):
            ...
    from repro_torch.obs.export import write_profile
    write_profile("out.json", col)           # open in ui.perfetto.dev

Or set ``REPRO_PROFILE=out.json`` in the environment to profile a whole
process, then ``python -m repro_torch.obs summarize out.json``.
`run_pipeline(..., profile="out.json")` profiles one plan.
"""

from .core import (
    PROFILE_ENV,
    Collector,
    complete,
    counter,
    current,
    disable,
    enable,
    enabled,
    event,
    gauge,
    observe,
    profiled,
    scoped,
    span,
)
from .metrics import DEFAULT_BUCKETS_US, Histogram, MetricsRegistry

__all__ = [
    "Collector",
    "DEFAULT_BUCKETS_US",
    "Histogram",
    "MetricsRegistry",
    "PROFILE_ENV",
    "complete",
    "counter",
    "current",
    "disable",
    "enable",
    "enabled",
    "event",
    "gauge",
    "observe",
    "profiled",
    "scoped",
    "span",
]
