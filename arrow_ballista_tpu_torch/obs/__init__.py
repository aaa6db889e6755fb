"""Observability of the port: tracing spans, per-job query profiles,
runtime statistics, the flight-recorder journal, the query doctor, live
progress and SLO burn rates, and the device observatory (a launch
registry over the port's own kernels, obs/device.py).

The port's copy of arrow_ballista_tpu/obs: a span layer propagated
scheduler -> executor -> operator, a per-job profile ring buffer, and a
pluggable span collector (noop / in-memory / OTLP-shaped export hook).
"""
from .tracing import (  # noqa: F401
    InMemorySpanCollector,
    NoopSpanCollector,
    OtlpSpanCollector,
    Span,
    SpanCollector,
    TaskSpanRecorder,
    make_collector,
    new_span_id,
    new_trace_context,
    new_trace_id,
    span_from_obj,
    span_to_obj,
)
from .profile import JobObservability, ProfileStore  # noqa: F401
from .stats import (  # noqa: F401
    ClusterHistory,
    RuntimeStatsStore,
    duration_quantiles,
    explain_analyze_report,
    local_explain_report,
    nearest_rank_quantile,
    render_explain_analyze,
    row_histogram,
    skew_coefficient,
    stage_summary,
)
from .trace_event import spans_to_chrome  # noqa: F401
from .journal import JournalEvent  # noqa: F401
from .doctor import (  # noqa: F401
    assemble_forensics,
    diagnose,
    render_diagnosis,
    validate_bundle,
)
from .progress import (  # noqa: F401
    job_progress,
    monotonic_fraction,
    render_progress_bar,
)
from .live import LiveDoctor  # noqa: F401
from .slo import (  # noqa: F401
    NullSloTracker,
    SloPolicy,
    SloTracker,
    tracker_from_config,
)
