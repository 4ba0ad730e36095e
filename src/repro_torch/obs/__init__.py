"""Round-level observability (mirrors ``repro.obs``): the metrics registry,
trace spans with the profiler hook, the versioned ``meta["telemetry"]``
envelope and ``python -m repro_torch.obs report``."""
from .envelope import TELEMETRY_SCHEMA_VERSION, build_envelope, series_arrays
from .registry import (BASE_AXES, ENV_TELEMETRY, Metric, collect_metrics,
                       get_metric, make_collector, metric_id,
                       metrics_registry, register_metric,
                       registered_metrics, resolve_metrics,
                       resolve_telemetry_request)
from .report import health_flags, render_report, report_file
from .trace import (ENV_TRACE_DIR, events, instant, memory_snapshots,
                    profiler, record_duration, record_memory_analysis, span,
                    span_summary, trace_dir, write_trace)

__all__ = [
    "TELEMETRY_SCHEMA_VERSION", "build_envelope", "series_arrays",
    "BASE_AXES", "ENV_TELEMETRY", "Metric", "collect_metrics", "get_metric",
    "make_collector", "metric_id", "metrics_registry", "register_metric",
    "registered_metrics", "resolve_metrics", "resolve_telemetry_request",
    "health_flags", "render_report", "report_file", "ENV_TRACE_DIR", "events",
    "instant", "memory_snapshots", "profiler", "record_duration",
    "record_memory_analysis", "span", "span_summary", "trace_dir",
    "write_trace",
]
