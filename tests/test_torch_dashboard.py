"""The port's dashboard (dashboard.py, dashboard_plugins.py) against the
JAX package's, headless: the DashboardState cases of tests/test_ui.py,
tests/test_observe.py and tests/test_health.py run on both packages on a
virtual clock with equal results (the services table, the EC share
mirror and a variable update, the log tail, the history page, the log
level and the kill fallback, a registered plugin, the metrics page and
the firing-alert lines); the built-in compute and placement plugin
pages and copying the topic path on the port; and the CLI's `dashboard`
command running its curses loop against a scripted screen."""

import curses
import json

import torch

from aiko_services_tpu.actor import Actor as JActor
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu_torch import cli as TCli
from aiko_services_tpu_torch.actor import Actor as TActor
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar

from torch_ops_host import Host, both

ACTORS = {"jax": JActor, "torch": TActor}
REGISTRARS = {"jax": JRegistrar, "torch": TRegistrar}


def with_registrar(package):
    host = Host(package)
    REGISTRARS[package](host.runtime("reg_host"))
    host.engine.clock.advance(2.1)
    host.settle()
    return host


def select(state, name):
    state.selected_index = [f.name for f in state.services()].index(name)


def test_state_tracks_services_shares_and_logs():
    def scenario(package):
        host = with_registrar(package)
        state = host.m.dashboard.DashboardState(host.runtime("dash_host"))
        host.settle()
        app_rt = host.runtime("app_host")
        actor = ACTORS[package](app_rt, "worker", share={"temperature": 21})
        host.settle(15)
        seen = [sorted(f.name for f in state.services())]
        select(state, "worker")
        state.open_variables()
        host.settle(15)
        flat = dict(state.flat_share())
        seen.append((state.page, flat.get("temperature"),
                     flat.get("lifecycle")))
        state.update_variable("temperature", 30)
        host.settle(10)
        seen.append((actor.ec_producer.get("temperature"),
                     dict(state.flat_share()).get("temperature")))
        state.update_variable("note", "(absent) means gone")
        host.settle(10)
        seen.append(actor.ec_producer.get("note"))
        state.back()
        state.open_log()
        app_rt.publish(actor.topic_log, "hello from worker")
        host.settle(6)
        seen.append((state.page, list(state.log_lines)))
        state.move(1)
        seen.append(state.selected().name)
        state.terminate()
        return seen
    seen = both(scenario)
    assert "worker" in seen[0] and "registrar" in seen[0]
    assert seen[1] == ("variables", 21, "ready")
    assert seen[2] == (30, 30) and seen[3] == "(absent) means gone"
    assert seen[4] == ("log", ["hello from worker"])


def test_history_page():
    def scenario(package):
        host = with_registrar(package)
        actor = ACTORS[package](host.runtime("app_host"), "doomed", share={})
        host.settle(10)
        actor.stop()
        host.settle(10)
        state = host.m.dashboard.DashboardState(host.runtime("dash_host"))
        host.settle(10)
        state.open_history()
        host.settle(10)
        seen = (state.page, state.history_complete,
                [f.name for f in state.history_rows])
        state.terminate()
        return seen
    page, complete, rows = both(scenario)
    assert page == "history" and complete and "doomed" in rows


def test_kill_falls_back_to_control_stop_and_sets_log_level():
    def scenario(package):
        host = with_registrar(package)
        actor = ACTORS[package](host.runtime("app_host"), "victim", share={})
        state = host.m.dashboard.DashboardState(host.runtime("dash_host"))
        host.settle(15)
        select(state, "victim")
        state.open_variables()
        host.settle(10)
        state.set_log_level("debug")
        host.settle(10)
        seen = [actor.ec_producer.get("log_level"), state.status]
        state.back()
        select(state, "victim")
        state.kill_selected()
        host.settle(15)
        seen += [state.status,
                 "victim" in [f.name for f in state.services()]]
        state.terminate()
        return seen
    level, status, killed, present = both(scenario)
    assert level == "DEBUG" and "DEBUG" in status
    assert "control_stop" in killed and not present


def test_registered_plugin_renders():
    def scenario(package):
        host = with_registrar(package)
        dashboard = host.m.dashboard
        state = dashboard.DashboardState(host.runtime("reg_view"))
        host.settle(10)
        dashboard.register_plugin(
            "registrar",
            lambda st, fields: [f"services: {len(st.services())}"])
        dashboard.register_plugin(
            "lifecycle_manager", lambda st, fields: 1 / 0)
        try:
            select(state, "registrar")
            lines = state.plugin_lines()
        finally:
            dashboard._PLUGINS.clear()
            host.m.plugins.register_builtins()
            state.terminate()
        return lines
    assert both(scenario) == ["services: 1"]


def test_metrics_page_and_alert_lines():
    snapshot = {
        "process": "p", "time": 1.0,
        "snapshot": {
            "c_total": {"type": "counter", "help": "",
                        "series": [{"labels": {"k": "v"}, "value": 4}]},
            "h_seconds": {"type": "histogram", "help": "",
                          "series": [{"labels": {}, "bounds": [1.0],
                                      "counts": [2, 0], "sum": 0.5,
                                      "count": 2}]},
            "kv_pool_occupancy": {"type": "gauge", "series": [
                {"labels": {"pool": "p0"}, "value": 0.5}]},
        }}

    def scenario(package):
        host = with_registrar(package)
        state = host.m.dashboard.DashboardState(host.runtime("dash_alert"))
        emitter = host.runtime("dash_emit")
        host.settle(10)
        select(state, "registrar")
        state.open_metrics()
        waiting = state.metrics_lines()
        emitter.publish(f"{emitter.namespace}/alert/hop-burn", json.dumps(
            {"rule": "hop-burn", "state": "firing", "since": 2.0,
             "description": "hops burning"}), retain=True)
        emitter.publish(f"{emitter.namespace}/alert/quiet-rule", json.dumps(
            {"rule": "quiet-rule", "state": "resolved", "time": 3.0}),
            retain=True)
        emitter.publish(f"{emitter.namespace}/alert/bad", "not json",
                        retain=True)
        registrar_path = state.selected().topic_path.rsplit("/", 1)[0]
        emitter.publish(f"{registrar_path}/0/metrics", json.dumps(snapshot),
                        retain=True)
        host.settle(10)
        seen = (waiting[-1].split(" on ")[0], state.alert_lines(),
                state.metrics_lines(), state.page)
        state.back()
        state.terminate()
        return seen
    waiting, alerts, lines, page = both(scenario)
    assert page == "metrics" and waiting == "waiting for a metrics snapshot"
    assert len(alerts) == 1 and "ALERT hop-burn firing" in alerts[0]
    text = "\n".join(lines)
    assert lines[0] == alerts[0]
    assert "c_total{k=v}" in text and "n=2" in text
    assert "mean=250.00ms" in text and "p95<=1000.00ms" in text
    assert "pool p0 50%" in text


def test_builtin_compute_and_placement_pages():
    """The shipped plugin pages render the port ComputeRuntime's device
    and a PlacementManager's pool occupancy."""
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.lifecycle import LifeCycleClient
    from aiko_services_tpu_torch.placement import (DevicePool,
                                                   PlacementManager)

    host = with_registrar("torch")
    host.m.plugins.register_builtins()
    app_rt = host.runtime("plug_app")
    ComputeRuntime(app_rt, "plug_compute", device="cpu")
    manager = PlacementManager(
        app_rt, "plug_pm",
        spawner=lambda cid, topic, ds: LifeCycleClient(
            host.runtime(f"plug_w{cid}"), f"plug_cl{cid}", topic, cid),
        pool=DevicePool([torch.device("cuda", i) for i in range(8)]),
        client_mesh_axes=4)
    manager.create_clients(1)
    state = host.m.dashboard.DashboardState(host.runtime("plug_dash"))
    host.settle(30)
    select(state, "plug_compute")
    state.open_variables()
    host.settle(20)
    lines = "\n".join(state.plugin_lines())
    assert "devices: 1 (cpu/cpu)" in lines and "device 0: mem n/a" in lines
    state.back()
    select(state, "plug_pm")
    state.open_variables()
    host.settle(20)
    lines = "\n".join(state.plugin_lines())
    assert "device pool: 4 allocated / 4 free of 8" in lines
    assert "client 0: devices=[0, 1, 2, 3]" in lines
    state.terminate()


def test_copy_topic_path_without_a_clipboard_tool(monkeypatch):
    import shutil
    monkeypatch.setattr(shutil, "which", lambda _: None)
    host = with_registrar("torch")
    state = host.m.dashboard.DashboardState(host.runtime("dash_copy"))
    host.settle(10)
    select(state, "registrar")
    path = state.copy_topic_path()
    assert path == state.selected().topic_path
    assert state.status == f"no clipboard tool; topic: {path}"
    state.terminate()


class ScriptedScreen:
    """A curses screen stand-in: getch replays `keys`, then 'q'; every
    rendered frame's lines are kept."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.frames, self.lines = [], {}

    def getmaxyx(self):
        return 24, 100

    def erase(self):
        self.lines = {}

    def addnstr(self, y, x, text, n, *attributes):
        self.lines[y] = text[:n]

    def refresh(self):
        self.frames.append(dict(self.lines))

    def nodelay(self, flag):
        pass

    def getch(self):
        return self.keys.pop(0) if self.keys else ord("q")


def test_cli_dashboard_runs_headless(monkeypatch):
    screen = ScriptedScreen([-1, ord("j"), ord("k"), ord("m"), ord("b"),
                             ord("l"), ord("b"), ord("h"), ord("b")])
    monkeypatch.setattr(curses, "wrapper", lambda loop: loop(screen))
    monkeypatch.setattr(curses, "curs_set", lambda visibility: None)
    monkeypatch.setattr("time.sleep", lambda seconds: None)
    assert TCli.main(["dashboard", "--transport", "memory"]) == 0
    titles = [frame[0] for frame in screen.frames]
    assert len(titles) == 9
    assert titles[0].startswith(" aiko_services_tpu_torch dashboard — "
                                "services — ")
    # an empty table (no service on the CLI's own broker): every page
    # key stays on the services page, and the history key says why
    assert all("— services —" in title for title in titles)
    # no registrar on the CLI's own broker: the history key says so
    assert any("no registrar" in frame[23] for frame in screen.frames)
    assert "↑/↓ select" in screen.frames[0][23]
