# XGO robot actor: teleoperated quadruped with camera streaming and
# telemetry.  The port's copy of examples/xgo_robot/xgo_robot.py
# (reference: examples/xgo_robot/xgo_robot.py, a robot actor with ~20
# RPC methods, zlib video publish, battery telemetry, hardware mocked
# off-robot).
#
# The hardware layer is injected; off-robot SimulatedXgo tracks the
# commanded state so the whole RPC surface, the telemetry share and the
# camera's tensor publish (elements.audio.encode_tensor) run anywhere.
# Run:
#   python -m aiko_services_tpu_torch.examples.xgo_robot.xgo_robot --self-test

# an example script: its console lines are its output
# graft: disable-file=lint-print

from __future__ import annotations

import sys

import numpy as np

from aiko_services_tpu_torch import Actor, ProcessRuntime, Registrar
from aiko_services_tpu_torch.elements.audio import encode_tensor
from aiko_services_tpu_torch.service import ServiceProtocol

__all__ = ["PROTOCOL_XGO", "SimulatedXgo", "XgoRobot", "self_test", "main"]

PROTOCOL_XGO = ServiceProtocol("xgo_robot")


class SimulatedXgo:
    """Off-robot hardware stand-in (reference mocks with is_robot() gates,
    xgo_robot.py:86-89)."""

    def __init__(self):
        self.pose = {"x": 0.0, "y": 0.0, "z": 100.0}
        self.attitude = {"roll": 0.0, "pitch": 0.0, "yaw": 0.0}
        self.arm_position = {"arm_x": 0.0, "arm_z": 0.0}
        self.claw_grip = 0
        self.battery = 100
        self.action_id = 0
        self._camera_phase = 0

    def read_battery(self) -> int:
        self.battery = max(0, self.battery - 1)
        return self.battery

    def capture_image(self) -> np.ndarray:
        self._camera_phase += 1
        image = np.zeros((120, 160, 3), np.uint8)
        image[:, (self._camera_phase * 4) % 160] = 255
        return image


class XgoRobot(Actor):
    """The robot service: RPC surface + telemetry share + video publish."""

    def __init__(self, runtime, hardware=None, name: str = "xgo_robot"):
        super().__init__(runtime, name, PROTOCOL_XGO, share={
            "battery": 100, "action": 0, "claw": 0,
            "pose.x": 0.0, "pose.y": 0.0, "pose.z": 100.0,
        })
        self.hardware = hardware or SimulatedXgo()
        self.video_topic = f"{self.topic_path}/video"
        self._video_timer = None
        self._telemetry_timer = runtime.event.add_timer_handler(
            self._telemetry, 5.0)

    # -- motion RPC (reference: xgo_robot.py:93-120) ------------------------
    def action(self, action_id) -> None:
        self.hardware.action_id = int(action_id)
        self.ec_producer.update("action", int(action_id))

    def move(self, direction, distance) -> None:
        axis = "x" if direction in ("forward", "backward") else "y"
        sign = 1.0 if direction in ("forward", "left") else -1.0
        self.hardware.pose[axis] += sign * float(distance)
        self.ec_producer.update(f"pose.{axis}",
                                self.hardware.pose[axis])

    def turn(self, degrees) -> None:
        self.hardware.attitude["yaw"] = \
            (self.hardware.attitude["yaw"] + float(degrees)) % 360.0

    def attitude(self, roll, pitch, yaw) -> None:
        self.hardware.attitude.update(roll=float(roll), pitch=float(pitch),
                                      yaw=float(yaw))

    def translation(self, x, y, z) -> None:
        self.hardware.pose.update(x=float(x), y=float(y), z=float(z))
        for axis in ("x", "y", "z"):
            self.ec_producer.update(f"pose.{axis}",
                                    self.hardware.pose[axis])

    def arm(self, arm_x, arm_z) -> None:
        self.hardware.arm_position.update(arm_x=float(arm_x),
                                          arm_z=float(arm_z))

    def claw(self, grip) -> None:
        self.hardware.claw_grip = int(grip)
        self.ec_producer.update("claw", int(grip))

    def reset(self) -> None:
        self.translation(0.0, 0.0, 100.0)
        self.attitude(0.0, 0.0, 0.0)

    def stop(self) -> None:
        if self._video_timer is not None:
            self.video_stop()
        self.runtime.event.remove_timer_handler(self._telemetry_timer)
        super().stop()

    # -- camera (reference: _publish_image zlib+np.save) --------------------
    def video_start(self, rate=10.0) -> None:
        if self._video_timer is not None:
            return

        def publish_frame():
            image = self.hardware.capture_image()
            self.runtime.publish(self.video_topic, encode_tensor(image))

        self._video_timer = self.runtime.event.add_timer_handler(
            publish_frame, 1.0 / float(rate))

    def video_stop(self) -> None:
        if self._video_timer is not None:
            self.runtime.event.remove_timer_handler(self._video_timer)
            self._video_timer = None

    # -- telemetry ----------------------------------------------------------
    def _telemetry(self) -> None:
        self.ec_producer.update("battery", self.hardware.read_battery())


def self_test(runtime) -> dict:
    """Registrar and robot on `runtime`: a move and a claw command over
    the RPC topic, then the camera at 50 Hz until three frames arrive;
    returns the robot's share and the frames decoded."""
    from ...elements.audio import decode_tensor
    Registrar(runtime)
    robot = XgoRobot(runtime)
    frames = []
    # the self-test's probe: the run below stops at three frames and the
    # caller terminates the runtime right after
    runtime.add_message_handler(
        lambda _t, payload: frames.append(decode_tensor(payload)),  # graft: disable=lint-unbounded-queue
        robot.video_topic, binary=True)
    runtime.event.run_until(lambda: runtime.registrar is not None,
                            timeout=6.0)
    runtime.publish(robot.topic_in, "(move forward 25)")
    runtime.publish(robot.topic_in, "(claw 128)")
    robot.video_start(rate=50.0)
    runtime.event.run_until(lambda: len(frames) >= 3, timeout=6.0)
    if robot.ec_producer.get("pose.x") != 25.0 or \
            robot.ec_producer.get("claw") != 128:
        raise RuntimeError(f"xgo self-test: pose.x "
                           f"{robot.ec_producer.get('pose.x')}, claw "
                           f"{robot.ec_producer.get('claw')}")
    return {"pose.x": robot.ec_producer.get("pose.x"),
            "claw": robot.ec_producer.get("claw"), "frames": frames}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runtime = ProcessRuntime(name="xgo_robot").initialize()
    if "--self-test" in argv:
        result = self_test(runtime)
        frames = result["frames"]
        print(f"self-test ok: pose.x=25.0 claw=128 "
              f"{len(frames)} video frames {frames[0].shape}")
        runtime.terminate()
        return
    XgoRobot(runtime)
    runtime.run()


if __name__ == "__main__":
    main()
