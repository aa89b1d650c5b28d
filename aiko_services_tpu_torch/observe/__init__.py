# observe: the telemetry layer: the metrics registry, distributed tracing
# with deadline propagation, the exporters, the health plane's series
# and SLO rules, journeys, the KV ledger, the decode-round phase
# profiler and the flight recorder (the names the JAX package's observe
# exports).
#
# Near-leaf on purpose: transport, event and pipeline record into this
# package, so the only framework import allowed here is utils.

from .metrics import (                                      # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, MirroredStats, Sketch,
    DEFAULT_LATENCY_BUCKETS, default_registry, log_buckets,
)
from .sketch import merge_sketches                          # noqa: F401
from .tracing import (                                      # noqa: F401
    TRACE_MARKER, SpanRecord, TraceContext, Tracer, activate,
    current_trace, new_trace, tracer,
)
from .export import (                                       # noqa: F401
    METRICS_TOPIC_SUFFIX, MetricsPublisher, chrome_trace,
    dump_chrome_trace, render_prometheus, render_snapshot_prometheus,
    series_key, series_quantile,
)
from .series import (                                       # noqa: F401
    ALERT_TOPIC_PREFIX, HealthAggregator, HistogramSeries, SLORule,
    ScalarSeries, SeriesStore, SketchSeries, parse_selector,
)
from .journey import (                                      # noqa: F401
    JourneyLog, RequestJourney, note_admission, take_admission_note,
    tenant_slo_rows,
)
from .ledger import (                                       # noqa: F401
    KVMemoryLedger, assert_ledger_clean, seed_ledger_leak,
)
from .profiler import PhaseProfiler, arm_trace              # noqa: F401
from .flight import (                                       # noqa: F401
    DumpOnAlert, FLIGHT_TOPIC_SUFFIX, FlightLogHandler, FlightRecorder,
)
