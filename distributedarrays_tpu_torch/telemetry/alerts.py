"""SLO burn-rate alerting + the always-on health sampler.

The port's copy of ``distributedarrays_tpu/telemetry/alerts.py``: the same
rules, alert events, gauges and environment switches; the HBM signals
read the port's device memory ledger (``telemetry.memory``), and
``autotune_regressed`` reads the ``autotune.advisor_rollbacks`` counter
as JAX's does: the advisor counts a tune it rolled back through
``utils/autotune.undo``, and until the advisor is ported (ROADMAP.md
queue A) nothing moves it.

The observatory so far is *forensic*: journals, bundles and incident
reconstruction tell you what happened after the fact.  This module is
the *while-it-degrades* half:

- **declarative alert rules** (:class:`AlertRule`): a signal callable, a
  breach predicate, and a fast/slow burn-rate window pair — the
  classic multi-window SRE pattern: the FAST window (is a large
  fraction of recent samples breaching?) makes the alert prompt, the
  SLOW window (is the breach sustained?) makes it noise-resistant.
  :func:`default_rules` builds the five stock rules: serve admitted
  p99, shed fraction, train step time, HBM live vs budget, and live
  device count.
- **in-process evaluation** (:class:`AlertManager`): rolling sample
  windows per rule, transitions journaled as typed ``alert`` events
  (``state=firing|cleared`` with the measured burn rates) and mirrored
  to ``alert.active`` gauges — ``da_tpu_alert_active`` in the
  Prometheus export, so a scraper sees exactly what the journal says.
- **the health sampler** (:func:`start_sampler`): a daemon thread
  (``DA_TPU_TELEMETRY_SAMPLE_S``, default OFF) snapshotting HBM live
  bytes, serve queue depth, train step rate and MFU (from the
  ``train_step_cost`` stamps on ``train.step`` spans) as journaled
  gauges every tick, and driving the alert manager — timelines get data
  *between* spans, and alerts fire without any cooperation from the
  workload.

Disabled telemetry (``DA_TPU_TELEMETRY=0``) keeps the one-check discipline:
the sampler never starts, and every evaluation entry point is a single
boolean check.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Callable

from . import core, memory

__all__ = ["AlertRule", "AlertManager", "default_rules",
           "autotune_regressed_rule", "ensure_autotune_rule",
           "start_sampler", "stop_sampler", "sampler_running",
           "SAMPLE_ENV"]

SAMPLE_ENV = "DA_TPU_TELEMETRY_SAMPLE_S"


@dataclasses.dataclass
class AlertRule:
    """One declarative SLO rule.

    ``signal``: ``() -> float | None`` — the current value (None = no
    sample this tick: the windows simply don't advance).  ``breach``:
    value predicate; or leave it None and set ``threshold`` + ``op``
    (``">"``: breaching when value > threshold, ``"<"``: when value <
    threshold — the live-device rule wants "too few").

    ``fast_window_s`` / ``slow_window_s``: the two rolling windows;
    ``fast_burn`` / ``slow_burn``: the breaching-sample fraction each
    window must exceed for the alert to fire.  It clears when the fast
    window's burn falls to half ``fast_burn`` (hysteresis: a boundary
    burn rate must not flap the alert every tick).
    """

    name: str
    signal: Callable[[], float | None]
    threshold: float = 0.0
    op: str = ">"
    breach: Callable[[float], bool] | None = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 0.5
    slow_burn: float = 0.1
    description: str = ""

    def is_breach(self, value: float) -> bool:
        if self.breach is not None:
            return bool(self.breach(value))
        if self.op == "<":
            return value < self.threshold
        return value > self.threshold


class AlertManager:
    """Evaluate a rule set over rolling windows; journal transitions.

    Drive it from the health sampler (:func:`start_sampler`) or call
    :meth:`evaluate` from your own loop.  Thread-safe; zero work when
    telemetry is disabled."""

    def __init__(self, rules=()):
        self._lock = threading.Lock()
        self._rules: list[AlertRule] = list(rules)
        # per rule name: deque[(t, breached)], firing flag
        self._windows: dict[str, deque] = {}
        self._firing: dict[str, bool] = {}

    def add(self, rule: AlertRule) -> None:
        with self._lock:
            self._rules.append(rule)

    def rules(self) -> list[AlertRule]:
        with self._lock:
            return list(self._rules)

    def firing(self) -> list[str]:
        """Names of currently-firing alerts."""
        with self._lock:
            return sorted(n for n, f in self._firing.items() if f)

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._firing.clear()

    @staticmethod
    def _burn(win: deque, now: float, horizon: float) -> tuple[float, int]:
        n = breached = 0
        for t, b in win:
            if now - t <= horizon:
                n += 1
                breached += 1 if b else 0
        return (breached / n if n else 0.0), n

    def evaluate(self, now: float | None = None) -> dict[str, bool]:
        """Sample every rule's signal, advance its windows, and fire /
        clear on burn-rate transitions.  Returns ``{name: firing}``."""
        if not core._ENABLED:
            return {}
        if now is None:
            now = time.monotonic()
        out: dict[str, bool] = {}
        with self._lock:
            rules = list(self._rules)
        for rule in rules:
            try:
                value = rule.signal()
            except Exception:
                value = None             # a broken signal is no sample
            with self._lock:
                win = self._windows.setdefault(rule.name, deque())
                if value is not None:
                    win.append((now, rule.is_breach(float(value))))
                # expire past the slow horizon
                while win and now - win[0][0] > rule.slow_window_s:
                    win.popleft()
                fast, nf = self._burn(win, now, rule.fast_window_s)
                slow, ns = self._burn(win, now, rule.slow_window_s)
                was = self._firing.get(rule.name, False)
                if not was and nf >= 1 and ns >= 1 and \
                        fast >= rule.fast_burn and slow >= rule.slow_burn:
                    firing = True
                elif was and fast <= rule.fast_burn / 2.0:
                    firing = False
                else:
                    firing = was
                self._firing[rule.name] = firing
            if firing != was:
                state = "firing" if firing else "cleared"
                core.count("alerts.transitions", alert=rule.name,
                           state=state)
                core.event("alert", rule.name, state=state,
                           value=value, burn_fast=round(fast, 4),
                           burn_slow=round(slow, 4),
                           threshold=rule.threshold,
                           description=rule.description)
            # gauge on every tick, not just transitions: a scrape between
            # transitions must still see the active set
            core.set_gauge("alert.active", 1.0 if firing else 0.0,
                           alert=rule.name)
            out[rule.name] = firing
        return out


def _counter_total(name: str) -> float:
    """Sum a counter over ALL label sets (``name`` and ``name{...}``)."""
    prefix = name + "{"
    with core._LOCK:
        return sum(v for k, v in core._counters.items()
                   if k == name or k.startswith(prefix))


def _shed_fraction_signal():
    """Incremental shed fraction between evaluations: d(shed)/d(submitted)
    since the last sample — a windowed rate, not the process-lifetime
    average (which would never clear after an incident)."""
    last = {"shed": 0.0, "submitted": 0.0}

    def signal() -> float | None:
        shed = _counter_total("serve.shed")
        sub = _counter_total("serve.submitted")
        d_shed = shed - last["shed"]
        d_sub = sub - last["submitted"]
        last["shed"], last["submitted"] = shed, sub
        if d_sub <= 0:
            return None                  # no traffic: no sample
        return max(d_shed, 0.0) / d_sub
    return signal


def default_rules(*, p99_slo_s: float = 0.5, shed_slo: float = 0.1,
                  step_time_slo_s: float | None = None,
                  hbm_budget_bytes: int | None = None,
                  hbm_slo: float = 0.9,
                  min_live_devices: int | None = None,
                  fast_window_s: float = 60.0,
                  slow_window_s: float = 300.0) -> list[AlertRule]:
    """The five stock rules from the observatory design:

    - ``serve_p99``      — admitted-request rolling p99 over the SLO
      (``serve.request_p99_s`` gauge, published by the server per
      dispatch);
    - ``serve_shed``     — fraction of submissions shed between ticks;
    - ``train_step_time`` — ``train.step_s`` gauge over its SLO (rule
      omitted when ``step_time_slo_s`` is None);
    - ``hbm_live``       — HBM ledger live bytes over ``hbm_slo`` of the
      budget (omitted without a budget; pass the server config's
      ``resolved_hbm_budget()``);
    - ``live_devices``   — ``elastic.live_devices`` gauge UNDER
      ``min_live_devices`` (omitted when None).
    """
    win = {"fast_window_s": fast_window_s, "slow_window_s": slow_window_s}
    rules = [
        AlertRule("serve_p99",
                  lambda: core.gauge_value("serve.request_p99_s"),
                  threshold=p99_slo_s, **win,
                  description=f"serve admitted p99 > {p99_slo_s}s"),
        AlertRule("serve_shed", _shed_fraction_signal(),
                  threshold=shed_slo, **win,
                  description=f"shed fraction > {shed_slo:.0%}"),
    ]
    if step_time_slo_s is not None:
        rules.append(AlertRule(
            "train_step_time",
            lambda: core.gauge_value("train.step_s"),
            threshold=step_time_slo_s, **win,
            description=f"train step time > {step_time_slo_s}s"))
    if hbm_budget_bytes:
        bound = float(hbm_budget_bytes) * hbm_slo
        rules.append(AlertRule(
            "hbm_live", lambda: float(memory.live_bytes()),
            threshold=bound, **win,
            description=f"HBM live bytes > {hbm_slo:.0%} of budget"))
    if min_live_devices is not None:
        rules.append(AlertRule(
            "live_devices",
            lambda: core.gauge_value("elastic.live_devices"),
            threshold=float(min_live_devices), op="<", **win,
            description=f"live devices < {min_live_devices}"))
    return rules


def _rollback_delta_signal():
    """Incremental ``autotune.advisor_rollbacks`` delta between
    evaluations — same windowed-rate pattern as the shed-fraction
    signal: a rollback is an *event*, and the process-lifetime total
    would keep the alert firing forever."""
    last = {"total": _counter_total("autotune.advisor_rollbacks")}

    def signal() -> float | None:
        total = _counter_total("autotune.advisor_rollbacks")
        delta = total - last["total"]
        last["total"] = total
        return max(delta, 0.0)
    return signal


def autotune_regressed_rule(*, fast_window_s: float = 60.0,
                            slow_window_s: float = 300.0) -> AlertRule:
    """A self-tune that regressed under the advisor's micro-probe and was
    rolled back is an *incident*, never a silent slowdown: the rule
    breaches on any new rollback since the previous evaluation (burn
    fractions near zero — one bad tune among healthy ticks must still
    page) and clears once the rollback sample ages out of the fast
    window."""
    return AlertRule(
        "autotune_regressed", _rollback_delta_signal(),
        threshold=0.0, op=">",
        fast_window_s=fast_window_s, slow_window_s=slow_window_s,
        fast_burn=0.01, slow_burn=0.01,
        description="advisor tune regressed under micro-probe; rolled back")


def ensure_autotune_rule(manager: AlertManager | None = None) -> AlertRule:
    """Idempotently register :func:`autotune_regressed_rule` on
    ``manager`` (default: the process-wide manager); returns the rule
    installed there."""
    mgr = manager if manager is not None else _default_manager
    for r in mgr.rules():
        if r.name == "autotune_regressed":
            return r
    rule = autotune_regressed_rule()
    mgr.add(rule)
    return rule


# ---------------------------------------------------------------------------
# the always-on health sampler
# ---------------------------------------------------------------------------


class _HealthSampler(threading.Thread):
    """Daemon thread: one ``sample/health`` journal event + journaled
    gauges per tick, plus one alert-manager evaluation.  Step rate and
    MFU derive from the ``train.step`` span events in the core ring —
    their ``train_step_cost`` flops stamps against the platform peak."""

    def __init__(self, interval_s: float, manager: AlertManager):
        super().__init__(name="da-tpu-health-sampler", daemon=True)
        self.interval_s = max(float(interval_s), 0.05)
        self.manager = manager
        self._stop = threading.Event()
        self._last_seq = -1
        self._peak_flops: float | None = None

    def stop(self) -> None:
        self._stop.set()

    def _train_window(self) -> tuple[int, float, float]:
        """(steps, seconds, flops) from train.step span events recorded
        since the previous tick."""
        steps = 0
        dur = flops = 0.0
        last = self._last_seq
        for e in core.events("span"):
            seq = e.get("seq", -1)
            if seq <= last or e.get("name") != "train.step":
                continue
            self._last_seq = max(self._last_seq, seq)
            steps += 1
            dur += float(e.get("dur") or 0.0)
            labels = e.get("labels") or {}
            try:
                flops += float(labels.get("flops") or 0.0)
            except (TypeError, ValueError):
                pass
        return steps, dur, flops

    def _tick(self) -> None:
        if not core._ENABLED:
            return
        fields: dict = {}
        try:
            live = memory.live_bytes()
            core.set_gauge("health.hbm_live_bytes", float(live),
                           journal=True)
            fields["hbm_live"] = int(live)
        except Exception:
            pass
        depth = core.gauge_value("serve.queue_depth")
        if depth is not None:
            fields["queue_depth"] = depth
        steps, dur, flops = self._train_window()
        if steps:
            rate = steps / self.interval_s
            core.set_gauge("health.step_rate", rate, journal=True)
            fields["step_rate"] = round(rate, 4)
            if flops > 0 and dur > 0:
                if self._peak_flops is None:
                    try:
                        from . import perf as _perf
                        self._peak_flops = float(
                            _perf.peaks_for(None)["flops"])
                    except Exception:
                        self._peak_flops = 0.0
                if self._peak_flops:
                    mfu = min(flops / dur / self._peak_flops, 1.0)
                    core.set_gauge("health.mfu", round(mfu, 6),
                                   journal=True)
                    fields["mfu"] = round(mfu, 6)
        core.event("sample", "health", **fields)
        try:
            self.manager.evaluate()
        except Exception:
            pass                  # the sampler must never kill the host
        # one sampler feeds journal, alerts, AND the live plane: when a
        # streaming exporter is armed the tick's fields go out with the
        # next frame (note_health is a single is-None check otherwise)
        try:
            from . import stream as _stream
            _stream.note_health(dict(fields, t=round(
                time.monotonic() - core._T0, 3)))
        except Exception:
            pass

    def run(self) -> None:  # pragma: no cover — exercised via ticks
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:
                pass


_sampler: _HealthSampler | None = None
_sampler_lock = threading.Lock()
_default_manager = AlertManager()


def default_manager() -> AlertManager:
    """The process-wide manager the sampler drives; add rules here
    (e.g. ``default_manager().add(rule)``) before or after start."""
    return _default_manager


def sampler_running() -> bool:
    with _sampler_lock:
        return _sampler is not None and _sampler.is_alive()


def start_sampler(interval_s: float | None = None,
                  rules=None) -> bool:
    """Start the health sampler daemon (idempotent).  ``interval_s``
    defaults to ``DA_TPU_TELEMETRY_SAMPLE_S``; with neither set (or
    telemetry disabled) nothing starts and False returns.  ``rules``
    (optional) are added to the default manager first."""
    global _sampler
    if not core._ENABLED:
        return False
    if interval_s is None:
        raw = os.environ.get(SAMPLE_ENV)
        if not raw:
            return False
        try:
            interval_s = float(raw)
        except ValueError:
            return False
    if interval_s <= 0:
        return False
    if rules:
        for r in rules:
            _default_manager.add(r)
    with _sampler_lock:
        if _sampler is not None and _sampler.is_alive():
            return True
        _sampler = _HealthSampler(interval_s, _default_manager)
        _sampler.start()
    core.event("sample", "start", interval_s=interval_s)
    return True


def stop_sampler() -> None:
    global _sampler
    with _sampler_lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()


def _maybe_autostart() -> None:
    """Import-time arm (called from ``telemetry/__init__``): start only
    when the env interval is set — mirrors flight's SIGUSR1 pattern.
    With DA_TPU_TELEMETRY=0 this is one boolean check."""
    if core._ENABLED and os.environ.get(SAMPLE_ENV):
        try:
            start_sampler()
        except Exception:
            pass


def _reset() -> None:
    _default_manager.reset()


core.register_reset_hook(_reset)
