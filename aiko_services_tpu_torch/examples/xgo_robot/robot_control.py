# XGO teleop client: keyboard drive + live camera + telemetry.  The
# port's copy of examples/xgo_robot/robot_control.py.
#
# The consumer half of the xgo example (reference:
# examples/xgo_robot/robot_control.py, a teleop UI subscribing to the
# robot's video topic and calling its RPC surface).  The control logic
# lives in RobotControl (headless, testable); run_teleop wraps it in a
# curses loop that renders the camera as ASCII luminance plus the
# EC-mirrored telemetry.
#
# Run (against a live robot or its simulation on the same control plane):
#   python -m aiko_services_tpu_torch.examples.xgo_robot.robot_control
# Self-test (robot + teleop in one process, no UI):
#   python -m aiko_services_tpu_torch.examples.xgo_robot.robot_control --self-test

# an example script: its console lines are its output
# graft: disable-file=lint-print

from __future__ import annotations

import sys

import numpy as np

from aiko_services_tpu_torch import ProcessRuntime, Registrar
from aiko_services_tpu_torch.actor import ActorDiscovery, get_remote_proxy
from aiko_services_tpu_torch.elements.audio import decode_tensor
from aiko_services_tpu_torch.service import ServiceFilter
from aiko_services_tpu_torch.share import ECConsumer

__all__ = ["MOVE_STEP", "TURN_STEP", "KEY_COMMANDS", "RobotControl",
           "frame_to_ascii", "run_teleop", "self_test", "main"]

MOVE_STEP = 10.0       # mm per keypress
TURN_STEP = 15.0       # degrees per keypress

# key -> (method, args) over the robot RPC surface
# (reference robot_control.py command map)
KEY_COMMANDS = {
    "w": ("move", ["forward", MOVE_STEP]),
    "s": ("move", ["backward", MOVE_STEP]),
    "a": ("move", ["left", MOVE_STEP]),
    "d": ("move", ["right", MOVE_STEP]),
    "q": ("turn", [-TURN_STEP]),
    "e": ("turn", [TURN_STEP]),
    "r": ("reset", []),
    "g": ("claw", [255]),
    "G": ("claw", [0]),
    "1": ("action", [1]),
    "2": ("action", [2]),
    "3": ("action", [3]),
}


class RobotControl:
    """Headless teleop model: discovery, RPC, video tail, telemetry."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.robot_topic_path = None
        self.proxy = None
        self.telemetry: dict = {}
        self._consumer = None
        self.last_frame = None
        self.frames_seen = 0
        self._video_topic = None
        from .xgo_robot import PROTOCOL_XGO
        self.discovery = ActorDiscovery(runtime)
        self.discovery.add_handler(
            self._robot_change, ServiceFilter(protocol=str(PROTOCOL_XGO)))

    # -- discovery ----------------------------------------------------------
    def _robot_change(self, event: str, fields) -> None:
        if event == "add" and self.proxy is None:
            self._attach(fields)
        elif event == "remove" and \
                fields.topic_path == self.robot_topic_path:
            self._detach()

    def _attach(self, fields) -> None:
        from .xgo_robot import XgoRobot     # the RPC protocol surface
        self.robot_topic_path = fields.topic_path
        self.proxy = get_remote_proxy(
            self.runtime, f"{fields.topic_path}/in", XgoRobot)
        self._consumer = ECConsumer(self.runtime, self.telemetry,
                                    f"{fields.topic_path}/control")
        self._video_topic = f"{fields.topic_path}/video"
        self.runtime.add_message_handler(self._on_video,
                                         self._video_topic, binary=True)

    def _detach(self) -> None:
        if self._consumer is not None:
            self._consumer.terminate()
            self._consumer = None
        if self._video_topic is not None:
            self.runtime.remove_message_handler(self._on_video,
                                                self._video_topic)
            self._video_topic = None
        self.proxy = None
        self.robot_topic_path = None
        self.telemetry.clear()

    @property
    def connected(self) -> bool:
        return self.proxy is not None

    # -- video --------------------------------------------------------------
    def _on_video(self, _topic, payload) -> None:
        try:
            self.last_frame = decode_tensor(payload)
            self.frames_seen += 1
        except Exception:
            pass

    def start_video(self, rate: float = 10.0) -> None:
        if self.proxy is not None:
            self.proxy.video_start(rate)

    def stop_video(self) -> None:
        if self.proxy is not None:
            self.proxy.video_stop()

    # -- commands -----------------------------------------------------------
    def handle_key(self, key: str) -> bool:
        """Dispatch a keypress to the robot; True when it mapped."""
        command = KEY_COMMANDS.get(key)
        if command is None or self.proxy is None:
            return False
        method, args = command
        getattr(self.proxy, method)(*args)
        return True

    def status_lines(self) -> list:
        """Telemetry summary for any frontend."""
        if not self.connected:
            return ["searching for robot..."]
        lines = [f"robot: {self.robot_topic_path}",
                 f"video frames: {self.frames_seen}"]
        for key in ("battery", "action", "claw",
                    "pose.x", "pose.y", "pose.z"):
            flat = self.telemetry.get("pose", {}) \
                if key.startswith("pose.") else self.telemetry
            name = key.split(".")[-1] if key.startswith("pose.") else key
            if isinstance(flat, dict) and name in flat:
                lines.append(f"{key}: {flat[name]}")
            elif key in self.telemetry:
                lines.append(f"{key}: {self.telemetry[key]}")
        return lines

    def terminate(self) -> None:
        self._detach()
        self.discovery.cache.terminate()


_ASCII_RAMP = " .:-=+*#%@"


def frame_to_ascii(frame: np.ndarray, width: int = 64,
                   height: int = 20) -> list:
    """Downsample an HxWx3 frame to ASCII luminance rows (block max —
    point sampling would drop thin features like edges/markers)."""
    if frame is None:
        return ["(no video)"]
    grey = frame.mean(axis=2) if frame.ndim == 3 else frame
    y_edges = np.linspace(0, grey.shape[0], height + 1).astype(int)
    x_edges = np.linspace(0, grey.shape[1], width + 1).astype(int)
    rows = []
    for y0, y1 in zip(y_edges[:-1], y_edges[1:]):
        row = []
        for x0, x1 in zip(x_edges[:-1], x_edges[1:]):
            block = grey[y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)]
            value = float(block.max()) if block.size else 0.0
            row.append(_ASCII_RAMP[int(value / 255.0 *
                                       (len(_ASCII_RAMP) - 1))])
        rows.append("".join(row))
    return rows


def run_teleop(runtime, tick: float = 0.03) -> None:
    """Blocking curses teleop loop (reference robot_control.py UI)."""
    import curses
    import time

    control = RobotControl(runtime)

    def loop(screen):
        curses.curs_set(0)
        screen.nodelay(True)
        video_on = False
        while True:
            for _ in range(8):
                runtime.event.step()
            key = screen.getch()
            if key in (27, ord("x")):
                break
            if key == ord("v"):
                (control.stop_video if video_on
                 else control.start_video)()
                video_on = not video_on
            elif key >= 0:
                control.handle_key(chr(key) if key < 256 else "")
            screen.erase()
            height, width = screen.getmaxyx()
            rows = frame_to_ascii(control.last_frame,
                                  width=min(64, width - 2),
                                  height=min(20, height - 10))
            for row, line in enumerate(rows[:height - 1]):
                screen.addnstr(row, 0, line, width - 1)
            for offset, line in enumerate(control.status_lines()):
                if len(rows) + offset < height - 2:
                    screen.addnstr(len(rows) + offset, 0, line, width - 1)
            footer = ("wasd move · q/e turn · g/G claw · 1-3 action · "
                      "r reset · v video · x quit")
            screen.addnstr(height - 1, 0, footer[:width - 1], width - 1,
                           curses.A_REVERSE)
            screen.refresh()
            time.sleep(tick)

    try:
        curses.wrapper(loop)
    finally:
        control.terminate()


def self_test(runtime) -> dict:
    """Robot and teleop on `runtime` with a registrar: the teleop finds
    the robot, drives it ("w", "g") and tails three video frames;
    returns what the JAX script's self-test prints."""
    from .xgo_robot import XgoRobot
    Registrar(runtime)
    robot = XgoRobot(runtime)
    control = RobotControl(runtime)
    runtime.event.run_until(lambda: control.connected, timeout=6.0)
    control.handle_key("w")
    control.handle_key("g")
    control.start_video(rate=50.0)
    runtime.event.run_until(
        lambda: control.frames_seen >= 3 and
        robot.ec_producer.get("claw") == 255, timeout=6.0)
    ascii_rows = frame_to_ascii(control.last_frame)
    lit = any(ch != " " for row in ascii_rows for ch in row)
    if robot.ec_producer.get("pose.x") != MOVE_STEP or not lit:
        raise RuntimeError(f"robot_control self-test: pose.x "
                           f"{robot.ec_producer.get('pose.x')}, "
                           f"{control.frames_seen} frames, camera lit: "
                           f"{lit}")
    result = {"pose.x": robot.ec_producer.get("pose.x"),
              "claw": robot.ec_producer.get("claw"),
              "frames": control.frames_seen, "ascii_rows": len(ascii_rows)}
    control.terminate()
    return result


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runtime = ProcessRuntime(name="robot_control").initialize()
    if "--self-test" in argv:
        result = self_test(runtime)
        print(f"self-test ok: drove robot to pose.x={MOVE_STEP}, "
              f"claw=255, {result['frames']} frames, "
              f"ascii {result['ascii_rows']} rows")
        runtime.terminate()
        return
    run_teleop(runtime)


if __name__ == "__main__":
    main()
