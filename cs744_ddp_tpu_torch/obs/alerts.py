"""Streaming SLO alert engine over telemetry gauges/counters/spans: the
reference package's ``obs/alerts.py``, rule for rule (the port imports
nothing of the reference).

A single-pass rules evaluator: feed it telemetry event records (live,
as a ``Telemetry`` tap, or post-hoc over a drained event list) and it
fires structured alerts with DETERMINISTIC rule ids — chaos drills pin
"exactly these rules fired" against ``fired_rules()`` / the
``summary["alerts"]`` roll-up, so a new false positive is a test
failure, not a dashboard shrug.

Built-in rules (id -> severity):

* ``SLO_BURN`` (page)   — SLO attainment over the sliding window of the
  last ``burn_window`` request outcomes (``serve_latency_ms`` gauges'
  ``met`` flag; sheds count as misses) dropped below
  ``burn_threshold``.
* ``SHED_RATE`` (warn)  — shed fraction over the same window above
  ``shed_threshold``.
* ``QUEUE_DEPTH`` (warn) — ``serve_queue_depth`` gauge above the high
  watermark.
* ``STRAGGLER`` (warn)  — one replica's EWMA service time exceeds the
  peer median by ``straggler_threshold``x (rides
  ``elastic.StragglerDetector`` over ``serve_service_ms`` gauges'
  ``replica`` attr; the port's own ``elastic/straggler.py``).
* ``PUBLISH_LAG`` (warn) — the weight watcher fell behind the
  publisher: a ``publish_rejected``/``publish_stale_skipped`` counter,
  or ``installed_version`` still trailing
  ``publish_version``/``publish_latest_seen`` more than
  ``publish_lag_s`` after the publish.
* ``NONFINITE`` (page)  — more than ``nonfinite_max`` non-finite train
  steps (``nonfinite_skipped``/``nonfinite_restored`` counters).

Each rule re-fires at most once per ``cooldown_s`` of EVENT time (not
wall time), so replaying a log yields the same alert sequence as the
live run that produced it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional

from .telemetry import NULL

# rule id -> severity (the full deterministic rule table).
RULES: Dict[str, str] = {
    "SLO_BURN": "page",
    "SHED_RATE": "warn",
    "QUEUE_DEPTH": "warn",
    "STRAGGLER": "warn",
    "PUBLISH_LAG": "warn",
    "NONFINITE": "page",
}


class Alert(NamedTuple):
    rule: str
    severity: str
    t: float
    attrs: Dict[str, Any]


class AlertEngine:
    """Single-pass rules evaluator; attach live with
    ``telemetry.add_tap(engine.observe)`` or replay with ``run()``."""

    def __init__(self, telemetry=NULL, *,
                 burn_window: int = 64, burn_threshold: float = 0.7,
                 shed_threshold: float = 0.5, queue_depth_high: int = 256,
                 straggler_threshold: float = 2.0,
                 straggler_min_steps: int = 3,
                 publish_lag_s: float = 5.0, nonfinite_max: int = 0,
                 cooldown_s: float = 5.0):
        self._tel = telemetry
        self.burn_window = int(burn_window)
        self.burn_threshold = float(burn_threshold)
        self.shed_threshold = float(shed_threshold)
        self.queue_depth_high = int(queue_depth_high)
        self.straggler_threshold = float(straggler_threshold)
        self.straggler_min_steps = int(straggler_min_steps)
        self.publish_lag_s = float(publish_lag_s)
        self.nonfinite_max = int(nonfinite_max)
        self.cooldown_s = float(cooldown_s)
        self.alerts: List[Alert] = []
        # RLock: firing goes through telemetry.alert(), whose tap fan-out
        # re-enters observe() on the same thread with the alert record.
        self._lock = threading.RLock()
        self._last_fire: Dict[str, float] = {}
        self._window: List[str] = []      # outcomes: "met"/"late"/"shed"
        self._detector = None             # lazily-built StragglerDetector
        self._nonfinite = 0.0
        self._published: Optional[float] = None   # newest published version
        self._published_t = 0.0
        self._installed: Optional[float] = None

    # -- firing --------------------------------------------------------------

    def _fire(self, rule: str, t: float, fired: List[Alert],
              **attrs) -> None:
        last = self._last_fire.get(rule)
        if last is not None and t - last < self.cooldown_s:
            return
        self._last_fire[rule] = t
        alert = Alert(rule, RULES[rule], t, attrs)
        self.alerts.append(alert)
        fired.append(alert)
        self._tel.alert(rule, RULES[rule], **attrs)

    # -- rule evaluation -----------------------------------------------------

    def _outcome(self, outcome: str, t: float, fired: List[Alert],
                 **attrs) -> None:
        self._window.append(outcome)
        if len(self._window) > self.burn_window:
            del self._window[:len(self._window) - self.burn_window]
        if len(self._window) < self.burn_window:
            return
        met = sum(1 for o in self._window if o == "met")
        shed = sum(1 for o in self._window if o == "shed")
        attainment = met / len(self._window)
        if attainment < self.burn_threshold:
            self._fire("SLO_BURN", t, fired, attainment=round(attainment, 4),
                       window=len(self._window), **attrs)
        if shed / len(self._window) > self.shed_threshold:
            self._fire("SHED_RATE", t, fired,
                       shed_rate=round(shed / len(self._window), 4),
                       window=len(self._window), **attrs)

    def _observe_straggler(self, replica: int, service_s: float,
                           t: float, fired: List[Alert]) -> None:
        # Lazy: the ``elastic`` package pulls the training step at import;
        # a replay of a stream that holds no replica gauges never needs it.
        from ..elastic.straggler import StragglerDetector
        det = self._detector
        if det is None or replica >= det.world:
            grown = StragglerDetector(
                replica + 1 if det is None else max(det.world, replica + 1),
                threshold=self.straggler_threshold,
                min_steps=self.straggler_min_steps)
            if det is not None:   # transplant EWMA state into the wider one
                grown._ewma[:det.world] = det._ewma
                grown._count[:det.world] = det._count
                grown.flag_counts = det.flag_counts
            det = self._detector = grown
        det.observe(replica, service_s)
        for r in det.check():
            self._fire("STRAGGLER", t, fired, replica=r,
                       ewma_s=round(det.ewma(r) or 0.0, 4))

    def _observe_publish(self, t: float, fired: List[Alert]) -> None:
        if self._published is None:
            return
        if self._installed is not None and \
                self._installed >= self._published:
            return
        if t - self._published_t > self.publish_lag_s:
            self._fire("PUBLISH_LAG", t, fired,
                       published=self._published,
                       installed=self._installed,
                       lag_s=round(t - self._published_t, 3))

    # -- the streaming entry point -------------------------------------------

    def observe(self, event: Dict[str, Any]) -> List[Alert]:
        """Feed one telemetry record; returns alerts fired by it.
        Usable directly as a ``Telemetry`` tap."""
        kind = event.get("kind")
        if kind == "alert":      # our own emissions echo back via the tap
            return []
        fired: List[Alert] = []
        t = float(event.get("t", 0.0))
        name = event.get("name")
        with self._lock:
            if kind == "gauge":
                if name == "serve_latency_ms" and "met" in event:
                    self._outcome("met" if event["met"] else "late", t,
                                  fired, tier=event.get("tier"))
                elif name == "serve_queue_depth":
                    if event.get("value", 0) > self.queue_depth_high:
                        self._fire("QUEUE_DEPTH", t, fired,
                                   depth=event["value"],
                                   high=self.queue_depth_high)
                elif name == "serve_service_ms" and "replica" in event:
                    self._observe_straggler(int(event["replica"]),
                                            event["value"] / 1e3, t, fired)
                elif name in ("publish_version", "publish_latest_seen"):
                    v = float(event["value"])
                    if self._published is None or v > self._published:
                        self._published, self._published_t = v, t
                elif name == "installed_version":
                    self._installed = float(event["value"])
            elif kind == "counter":
                if name == "serve_shed":
                    for _ in range(int(event.get("inc", 1))):
                        self._outcome("shed", t, fired,
                                      tier=event.get("tier"))
                elif name in ("publish_rejected", "publish_stale_skipped"):
                    self._fire("PUBLISH_LAG", t, fired, counter=name,
                               reason=event.get("why"))
                elif name in ("nonfinite_skipped", "nonfinite_restored"):
                    self._nonfinite += float(event.get("inc", 1))
                    if self._nonfinite > self.nonfinite_max:
                        self._fire("NONFINITE", t, fired,
                                   count=self._nonfinite)
            # Publish lag is time-driven: ANY event advancing the clock
            # can trip it once the watcher trails long enough.
            self._observe_publish(t, fired)
        return fired

    def run(self, events) -> List[Alert]:
        """Replay an event list through the rules; returns ALL alerts
        fired during the pass (deterministic in the event order)."""
        for e in events:
            self.observe(e)
        return list(self.alerts)

    # -- reporting -----------------------------------------------------------

    def fired_rules(self) -> List[str]:
        """Sorted unique rule ids that fired — the chaos-drill pin."""
        return sorted({a.rule for a in self.alerts})

    def summary(self) -> Dict[str, Any]:
        by_rule: Dict[str, Dict[str, Any]] = {}
        for a in self.alerts:
            agg = by_rule.setdefault(a.rule, {
                "count": 0, "severity": a.severity, "first_t": a.t})
            agg["count"] += 1
            agg["last_attrs"] = a.attrs
        return {"fired": self.fired_rules(), "by_rule": by_rule,
                "total": len(self.alerts)}
