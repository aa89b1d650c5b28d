# Dashboard: terminal UI over the live service table and EC shares.
#
# The port's own copy of aiko_services_tpu/dashboard.py:
#   * services page: live table from the ServicesCache (registrar replica);
#   * selecting a service ECConsumes its share and shows the variables
#     live, with the plugin page of its protocol (dashboard_plugins.py);
#   * update a share variable (publishes "(update name value)" to the
#     service's control topic), the log level among them;
#   * log page: tail of the selected service's log topic;
#   * metrics page: the process's retained metrics snapshot
#     (observe/export.py MetricsPublisher), led by firing SLO alerts
#     (observe/series.py HealthAggregator), per-tenant SLO rows and the
#     KV memory ledger;
#   * history page: the primary registrar's ring of departed services;
#   * kill (SIGKILL on this host, else (control_stop)) and copy the
#     topic path.
#
# Built on stdlib curses; rendering is separated from state
# (DashboardState) so the UI logic is testable headless, and
# `run_dashboard` drives the EventEngine and the screen from one loop.

from __future__ import annotations

import itertools
from collections import deque

from .service import ServiceFields, ServiceTopicPath
from .share import ECConsumer, ServicesCache
from .utils import generate, generate_sexpr, parse
from .utils.configuration import get_hostname, pid_verified
from .utils.sexpr import parse_int

__all__ = ["DashboardState", "run_dashboard", "register_plugin"]

_LOG_LIMIT = 256
_history_counter = itertools.count(1)   # unique response-topic suffixes

# Plugin pages keyed by protocol name : a plugin renders extra lines for a selected
# service of its protocol.
_PLUGINS: dict = {}


def register_plugin(protocol_name: str, render) -> None:
    """render(state, fields) -> list[str] shown under the share table."""
    _PLUGINS[protocol_name] = render


class DashboardState:
    """UI-independent dashboard model: the services table, the selected
    service's mirrored share, and its log tail."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.cache = ServicesCache(runtime)
        self.selected_index = 0
        # services | variables | log | history | metrics
        self.page = "services"
        self.share: dict = {}
        self._consumer = None
        self._log_topic = None
        self.log_lines: deque = deque(maxlen=_LOG_LIMIT)
        self.metrics_doc: dict | None = None    # latest snapshot JSON
        self._metrics_topic = None
        self.history_rows: list = []    # departed ServiceFields
        self._history_topic = None
        self._history_expected = None
        self.status = ""                # one-line feedback (kill, errors)
        # SLO alert records: retained {namespace}/alert/+
        # from every HealthAggregator — always subscribed, so the
        # metrics pane leads with what is FIRING right now
        self.alerts: dict[str, dict] = {}
        self._alert_topic = f"{runtime.namespace}/alert/+"
        runtime.add_message_handler(self._on_alert, self._alert_topic)

    # -- services table -----------------------------------------------------
    def services(self) -> list:
        return sorted(self.cache.services,
                      key=lambda fields: fields.topic_path)

    def selected(self):
        services = self.services()
        if not services:
            return None
        self.selected_index %= len(services)
        return services[self.selected_index]

    def move(self, delta: int) -> None:
        services = self.services()
        if services:
            self.selected_index = (self.selected_index + delta) % \
                len(services)

    # -- share mirror -------------------------------------------------------
    def open_variables(self) -> None:
        fields = self.selected()
        if fields is None:
            return
        self.close_consumer()
        self.share = {}
        self._consumer = ECConsumer(self.runtime, self.share,
                                    f"{fields.topic_path}/control")
        self.page = "variables"

    def update_variable(self, name: str, value) -> None:
        fields = self.selected()
        if fields is not None:
            # double-encode like ECProducer._notify does: the receiving
            # side parse_sexpr-inverts every wire value, so a
            # single-encoded structured string would get over-parsed
            self.runtime.publish(
                f"{fields.topic_path}/control",
                generate("update", [name, generate_sexpr(value)]))

    def close_consumer(self) -> None:
        if self._consumer is not None:
            self._consumer.terminate()
            self._consumer = None

    # -- log tail -----------------------------------------------------------
    def open_log(self) -> None:
        fields = self.selected()
        if fields is None:
            return
        self.close_log()
        self.log_lines.clear()
        self._log_topic = f"{fields.topic_path}/log"
        self.runtime.add_message_handler(self._on_log, self._log_topic)
        self.page = "log"

    def _on_log(self, _topic, payload) -> None:
        # audited: deque(maxlen=_LOG_LIMIT)  # graft: disable=lint-unbounded-queue
        self.log_lines.append(str(payload))

    def close_log(self) -> None:
        if self._log_topic is not None:
            self.runtime.remove_message_handler(self._on_log,
                                                self._log_topic)
            self._log_topic = None

    # -- metrics pane -------------------------------------------------------
    def open_metrics(self) -> None:
        """Subscribe to the selected service's PROCESS metrics topic
        ({namespace}/{host}/{pid}/0/metrics — retained snapshots from
        observe.MetricsPublisher) and render the latest snapshot."""
        fields = self.selected()
        if fields is None:
            return
        self.close_metrics()
        self.metrics_doc = None
        process_path = fields.topic_path.rsplit("/", 1)[0]
        from .observe.export import METRICS_TOPIC_SUFFIX
        self._metrics_topic = f"{process_path}/{METRICS_TOPIC_SUFFIX}"
        self.runtime.add_message_handler(self._on_metrics,
                                         self._metrics_topic)
        self.page = "metrics"

    def _on_metrics(self, _topic, payload) -> None:
        from .observe.export import parse_retained_json
        document = parse_retained_json(payload)
        if document is not None:
            self.metrics_doc = document

    def _on_alert(self, _topic, payload) -> None:
        from .observe.export import parse_retained_json
        record = parse_retained_json(payload, require_key="rule")
        if record is not None:
            # keyed by configured SLO rule names — bounded:
            # graft: disable=lint-unbounded-cache
            self.alerts[str(record["rule"])] = record

    def alert_lines(self) -> list:
        """One line per FIRING SLO alert (empty when healthy)."""
        lines = []
        for rule in sorted(self.alerts):
            record = self.alerts[rule]
            if record.get("state") != "firing":
                continue
            description = record.get("description", "")
            lines.append(f"ALERT {rule} firing since "
                         f"{record.get('since', '?')}"
                         + (f" — {description}" if description else ""))
        return lines

    def close_metrics(self) -> None:
        if self._metrics_topic is not None:
            self.runtime.remove_message_handler(self._on_metrics,
                                                self._metrics_topic)
            self._metrics_topic = None

    def metrics_lines(self) -> list:
        """The metrics page body: the latest published snapshot as
        aligned text rows (counters/gauges by series, histograms as
        count / mean / approximate p50+p95 from bucket counts)."""
        doc = self.metrics_doc
        # firing alerts lead even with no snapshot yet: a dead fleet
        # (no live publisher) with retained alerts is exactly when the
        # pane matters most
        lines = self.alert_lines()
        if not doc:
            return lines + ["waiting for a metrics snapshot on "
                            f"{self._metrics_topic} ..."]
        from .observe.export import series_key, series_quantile
        lines.append(f"process: {doc.get('process', '?')}  "
                     f"time: {doc.get('time', '?')}")
        snapshot = doc.get("snapshot", {})
        # per-tenant SLO rows: deadline attainment + merged
        # sketch p95s lead the pane — the per-series listing below is
        # forensics, this is the verdict
        from .observe.journey import tenant_slo_rows
        rows = tenant_slo_rows([snapshot])
        if rows:
            lines.append("  tenant SLO (journeys + merged sketches):")
            for row in rows:
                attainment = "-" if row["attainment"] is None else \
                    f"{row['attainment']:.3f}"
                ttft = "-" if row["ttft_p95_ms"] is None else \
                    f"{row['ttft_p95_ms']:.1f}ms"
                itl = "-" if row["itl_p95_ms"] is None else \
                    f"{row['itl_p95_ms']:.2f}ms"
                lines.append(
                    f"    {row['tenant']:16.16s} met={attainment} "
                    f"ttft_p95={ttft} itl_p95={itl} "
                    f"shed={row['shed']} rejected={row['rejected']}")
        lines.extend(self._memory_lines(snapshot, rows))
        for name in sorted(snapshot):
            entry = snapshot[name]
            for series in entry.get("series", []):
                shown = series_key(name, series.get("labels", {}))
                if entry.get("type") == "histogram":
                    count = series.get("count", 0)
                    mean = (series.get("sum", 0.0) / count) if count \
                        else 0.0
                    p50 = series_quantile(series, 0.5)
                    p95 = series_quantile(series, 0.95)
                    lines.append(f"  {shown:46.46s} n={count} "
                                 f"mean={mean * 1000.0:.2f}ms "
                                 f"p50<={p50 * 1000.0:.2f}ms "
                                 f"p95<={p95 * 1000.0:.2f}ms")
                else:
                    lines.append(f"  {shown:46.46s} "
                                 f"{series.get('value', 0)}")
        return lines

    def _memory_lines(self, snapshot: dict, rows: list) -> list:
        """KV memory section: per-tier occupancy, top
        tenants by attributed bytes, and firing ledger-violation
        alerts — empty when the snapshot carries no ledger families."""
        lines = []
        occupancy = []
        for series in snapshot.get("kv_pool_occupancy",
                                   {}).get("series", []):
            labels = series.get("labels", {}) or {}
            occupancy.append(
                f"pool {labels.get('pool', '?')} "
                f"{float(series.get('value', 0)):.0%}")
        for series in snapshot.get("kv_ledger_host_pressure",
                                   {}).get("series", []):
            occupancy.append(
                f"host {float(series.get('value', 0)):.0%}")
        by_bytes = sorted(
            (row for row in rows
             if row.get("device_bytes") or row.get("host_bytes")),
            key=lambda r: -(r["device_bytes"] + r["host_bytes"]))
        violations = sum(
            float(series.get("value", 0))
            for series in snapshot.get("kv_ledger_violations",
                                       {}).get("series", []))
        if not (occupancy or by_bytes or violations):
            return lines
        lines.append("  KV memory (ledger):")
        if occupancy:
            lines.append("    occupancy: " + "  ".join(occupancy))
        for row in by_bytes[:4]:
            lines.append(
                f"    {row['tenant']:16.16s} "
                f"device={row['device_bytes']:,d}B "
                f"host={row['host_bytes']:,d}B "
                f"byte_s={row['byte_seconds']:,.0f} "
                f"demote/promote={row['demotions']}/"
                f"{row['promotions']}")
        if violations:
            lines.append(f"    VIOLATIONS: {int(violations)} "
                         f"(kv_ledger_violations latched)")
        for rule in sorted(self.alerts):
            record = self.alerts[rule]
            if record.get("state") == "firing" and \
                    "ledger" in rule.lower():
                lines.append(f"    ALERT {rule} firing — "
                             f"{record.get('description', '')}")
        return lines

    # -- registrar history --------------------------------------------------
    def open_history(self, count: int = 64) -> None:
        """Ask the primary registrar for its ring buffer of departed
        services (the `(history response count)` protocol)."""
        registrar = self.runtime.registrar
        if registrar is None:
            self.status = "no registrar"
            return
        self.close_history()
        self.history_rows = []
        self._history_topic = (f"{self.runtime.topic_path}/0/history/"
                               f"{next(_history_counter)}")
        self._history_expected = None
        self.runtime.add_message_handler(self._on_history,
                                         self._history_topic)
        self.runtime.publish(
            f"{registrar['topic_path']}/in",
            generate("history", [self._history_topic, str(count)]))
        self.page = "history"

    def _on_history(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "item_count" and params:
            self._history_expected = parse_int(params[0], 0)
        elif command == "history" and params:
            try:
                # audited: reset per history request, bounded by the
                # registrar's requested count  # graft: disable=lint-unbounded-queue
                self.history_rows.append(ServiceFields.from_record(
                    params[0]))
            except Exception:
                pass

    @property
    def history_complete(self) -> bool:
        return (self._history_expected is not None and
                len(self.history_rows) >= self._history_expected)

    def close_history(self) -> None:
        if self._history_topic is not None:
            self.runtime.remove_message_handler(self._on_history,
                                                self._history_topic)
            self._history_topic = None

    # -- process kill -------------------------------------------------------
    def kill_selected(self) -> None:
        """Terminate the selected service's process: SIGKILL when it is
        on this host; for remote processes fall back to a graceful
        `(control_stop)` to the service."""
        fields = self.selected()
        if fields is None:
            return
        topic_path = ServiceTopicPath.parse(fields.topic_path)
        pid = None
        if topic_path is not None:
            try:
                pid = int(topic_path.process_id.split("-")[0])
            except ValueError:
                pid = None
        import os
        if topic_path is not None and pid is not None and \
                topic_path.hostname == get_hostname() and \
                pid != os.getpid():
            # a stale table row whose pid was recycled by an unrelated
            # process must not be SIGKILLed — only signal pids whose
            # cmdline still looks like one of ours
            if not pid_verified(pid):
                self.runtime.publish(f"{fields.topic_path}/in",
                                     "(control_stop)")
                self.status = (f"pid {pid} not verified as aiko — "
                               f"sent control_stop to {fields.name}")
                return
            import signal
            try:
                os.kill(pid, signal.SIGKILL)
                self.status = f"killed pid {pid} ({fields.name})"
            except OSError as exc:
                self.status = f"kill {pid} failed: {exc}"
            return
        self.runtime.publish(f"{fields.topic_path}/in", "(control_stop)")
        self.status = f"sent control_stop to {fields.name}"

    # -- clipboard ----------------------------------------------------------
    def copy_topic_path(self) -> str | None:
        """Copy the selected service's topic path to the system
        clipboard (the 'c' key).  Tries the
        usual clipboard tools; headless hosts still get the path in
        the status line (and the return value) to select manually."""
        fields = self.selected()
        if fields is None:
            return None
        text = fields.topic_path
        import shutil
        import subprocess
        for tool in (["wl-copy"], ["xclip", "-selection", "clipboard"],
                     ["xsel", "--clipboard", "--input"], ["pbcopy"]):
            if shutil.which(tool[0]):
                try:
                    subprocess.run(tool, input=text.encode(),
                                   timeout=2, check=True)
                    self.status = f"copied {text}"
                    return text
                except (OSError, subprocess.SubprocessError):
                    continue
        self.status = f"no clipboard tool; topic: {text}"
        return text

    # -- log level ------------------------------------------------------------
    def set_log_level(self, level: str) -> None:
        """Publish `(update log_level LEVEL)` to the selected service —
        every actor's share applies it live."""
        self.update_variable("log_level", str(level).upper())
        self.status = f"log_level → {str(level).upper()}"

    def back(self) -> None:
        self.close_consumer()
        self.close_log()
        self.close_history()
        self.close_metrics()
        self.status = ""
        self.page = "services"

    def plugin_lines(self) -> list:
        """Extra page content from the plugin registered for the selected
        service's protocol."""
        fields = self.selected()
        if fields is None:
            return []
        protocol_name = fields.protocol.rsplit("/", 1)[-1].split(":")[0]
        plugin = _PLUGINS.get(protocol_name)
        if plugin is None:
            return []
        try:
            return list(plugin(self, fields))
        except Exception as exc:
            return [f"plugin error: {exc!r}"]

    def flat_share(self) -> list:
        rows = []
        for key, value in sorted(self.share.items()):
            if isinstance(value, dict):
                for sub, sub_value in sorted(value.items()):
                    rows.append((f"{key}.{sub}", sub_value))
            else:
                rows.append((key, value))
        return rows

    def terminate(self) -> None:
        self.back()
        self.runtime.remove_message_handler(self._on_alert,
                                            self._alert_topic)
        self.cache.terminate()


def _render(screen, state: DashboardState) -> None:
    import curses

    screen.erase()
    height, width = screen.getmaxyx()
    title = (f" aiko_services_tpu_torch dashboard — {state.page} — "
             f"{state.runtime.namespace} ")
    screen.addnstr(0, 0, title.ljust(width - 1), width - 1,
                   curses.A_REVERSE)

    if state.page == "services":
        header = f"{'SERVICE':32.32s} {'PROTOCOL':24.24s} TOPIC"
        screen.addnstr(1, 0, header, width - 1, curses.A_BOLD)
        for row, fields in enumerate(state.services()[:height - 3]):
            attribute = curses.A_REVERSE if row == state.selected_index \
                else curses.A_NORMAL
            protocol = fields.protocol.rsplit("/", 1)[-1]
            line = (f"{fields.name:32.32s} {protocol:24.24s} "
                    f"{fields.topic_path}")
            screen.addnstr(2 + row, 0, line, width - 1, attribute)
        footer = ("↑/↓ select · ⏎ variables · l log · h history · "
                  "m metrics · x kill · q quit")
    elif state.page == "variables":
        fields = state.selected()
        screen.addnstr(1, 0, f"share: {fields.name if fields else '?'}",
                       width - 1, curses.A_BOLD)
        # plugin lines first: they must stay visible even when the share
        # table alone exceeds the screen
        rows = state.plugin_lines()
        rows += [f"{key:40.40s} {value}"
                 for key, value in state.flat_share()]
        for row, line in enumerate(rows[:height - 3]):
            screen.addnstr(2 + row, 0, line, width - 1)
        footer = "d/i/w/e log-level · b back · q quit"
    elif state.page == "metrics":
        screen.addnstr(1, 0, f"metrics: {state._metrics_topic}",
                       width - 1, curses.A_BOLD)
        for row, line in enumerate(state.metrics_lines()[:height - 3]):
            screen.addnstr(2 + row, 0, line, width - 1)
        footer = "b back · q quit"
    elif state.page == "history":
        header = f"{'DEPARTED SERVICE':32.32s} {'PROTOCOL':24.24s} TOPIC"
        screen.addnstr(1, 0, header, width - 1, curses.A_BOLD)
        for row, fields in enumerate(state.history_rows[:height - 3]):
            protocol = fields.protocol.rsplit("/", 1)[-1]
            line = (f"{fields.name:32.32s} {protocol:24.24s} "
                    f"{fields.topic_path}")
            screen.addnstr(2 + row, 0, line, width - 1)
        footer = "b back · q quit"
    else:
        screen.addnstr(1, 0, f"log: {state._log_topic}", width - 1,
                       curses.A_BOLD)
        lines = list(state.log_lines)[-(height - 3):]
        for row, line in enumerate(lines):
            screen.addnstr(2 + row, 0, line, width - 1)
        footer = "b back · q quit"
    if state.status:
        footer = f"{state.status} · {footer}"
    screen.addnstr(height - 1, 0, footer.ljust(width - 1), width - 1,
                   curses.A_REVERSE)
    screen.refresh()


def run_dashboard(runtime, tick: float = 0.05) -> None:
    """Blocking curses loop; drives the runtime's EventEngine inline
    (a 20 FPS refresh)."""
    import curses

    from .dashboard_plugins import register_builtins
    register_builtins()

    state = DashboardState(runtime)

    def loop(screen):
        curses.curs_set(0)
        screen.nodelay(True)
        while True:
            for _ in range(8):
                runtime.event.step()
            key = screen.getch()
            if key in (ord("q"), 27):
                break
            elif key in (curses.KEY_UP, ord("k")):
                state.move(-1)
            elif key in (curses.KEY_DOWN, ord("j")):
                state.move(1)
            elif key in (curses.KEY_ENTER, 10, 13) and \
                    state.page == "services":
                state.open_variables()
            elif key == ord("l") and state.page == "services":
                state.open_log()
            elif key == ord("h") and state.page == "services":
                state.open_history()
            elif key == ord("m") and state.page == "services":
                state.open_metrics()
            elif key == ord("x") and state.page == "services":
                state.kill_selected()
            elif key == ord("c"):
                state.copy_topic_path()
            elif state.page == "variables" and key in (
                    ord("d"), ord("i"), ord("w"), ord("e")):
                state.set_log_level({"d": "DEBUG", "i": "INFO",
                                     "w": "WARNING",
                                     "e": "ERROR"}[chr(key)])
            elif key == ord("b"):
                state.back()
            _render(screen, state)
            import time
            time.sleep(tick)

    try:
        curses.wrapper(loop)
    finally:
        state.terminate()
