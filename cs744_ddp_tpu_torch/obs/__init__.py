"""Observability of the training loop: the device-resident metric ring
(``ringbuf``), drained once per window, and the structured telemetry
recorder (``telemetry``): per-step events, spans, gauges, a run manifest
and an end-of-run summary, written only when the caller opts in
(``--telemetry-out``), the cross-process trace context that rides the
serving wire (``tracing``), the streaming SLO alert engine over that
telemetry (``alerts``), the cross-process waterfalls (``aggregate``),
the join of the cost model with measured time (``attribution``) and the
run-directory report (``report``: ``python -m cs744_ddp_tpu_torch.obs.
report DIR``).
Disabled is the default and costs nothing: ``NULL`` is a stateless no-op
recorder and every hot call site guards on ``telemetry.enabled``."""

from .alerts import RULES as ALERT_RULES
from .alerts import Alert, AlertEngine
from .telemetry import (NULL, NullTelemetry, Telemetry, git_sha, percentile,
                        read_run, summarize_events)
from .tracing import TraceContext

__all__ = ["ALERT_RULES", "Alert", "AlertEngine", "NULL", "NullTelemetry",
           "Telemetry", "TraceContext", "git_sha", "percentile", "read_run",
           "ringbuf", "summarize_events"]
