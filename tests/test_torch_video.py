"""The port's video elements (elements/video.py, elements/video_stream.py)
against the JAX package's: PE_VideoReadFile and PE_VideoWriteFile on a
video that OpenCV writes into tmp_path (both packages read the same
frames), PE_Tracker scripts (births, matches, ageing, deaths) whose
tracks equal JAX's frame by frame, and the port's counterparts of
tests/test_video_stream.py: the JPEG round trip (bytes equal JAX's), the
MJPEG server and the HTTP ingest element, H.264 file egress and a failed
open, UDP loopback, a jitter buffer under loss, reordering and
interleaving, and a resync after a sender restart.  Each port pipeline
runs on a port engine under a virtual clock."""

import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.elements import video_stream as JVS
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.elements import video_stream as TVS
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

cv2 = pytest.importorskip("cv2")

PACKAGES = {"jax": (JE, JM, JProcessRuntime, JP),
            "torch": (TE, TM, TProcessRuntime, TP)}


def element(name, inputs=(), outputs=(), parameters=None):
    return {"name": name, "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "parameters": parameters or {}}


def build(package, name, graph, elements, parameters=None,
          element_classes=None):
    event, memory, runtime_class, module = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    runtime = runtime_class(name=f"{name}_host", engine=engine,
                            transport_factory=factory).initialize()
    definition = module.parse_pipeline_definition({
        "version": 0, "name": name, "runtime": "python", "graph": [graph],
        "parameters": parameters or {}, "elements": elements})
    pipeline = module.Pipeline(runtime, definition,
                               element_classes=element_classes,
                               stream_lease_time=0)
    return engine, pipeline


def collector(package, received):
    module = PACKAGES[package][3]

    class PE_Collect(module.PipelineElement):
        def process_frame(self, frame, image=None, **_):
            received.append(np.asarray(image))
            return module.FrameOutput(True, {})

    return {"PE_Collect": PE_Collect}


def write_video(path, frames=5, seed=2):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, (64, 48))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    writer.release()


def read_write(package, tmp_path, source):
    engine, pipeline = build(
        package, f"p_vid_{package}",
        "(PE_VideoReadFile PE_VideoWriteFile)",
        [element("PE_VideoReadFile", [], ["image"]),
         element("PE_VideoWriteFile", ["image"], [])],
        {"PE_VideoReadFile.rate": 100.0,
         "PE_VideoWriteFile.pathname":
             str(tmp_path / f"out_{package}_{{stream_id}}.mp4")})
    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("s1", lease_time=0, parameters={
        "PE_VideoReadFile.pathname": str(source)})
    for _ in range(60):
        engine.clock.advance(0.01)
        engine.step()
    capture = cv2.VideoCapture(str(tmp_path / f"out_{package}_s1.mp4"))
    written = 0
    while capture.read()[0]:
        written += 1
    capture.release()
    return [np.asarray(frame.swag["image"]) for frame in done], written


def test_video_read_write_matches_jax(tmp_path):
    source = tmp_path / "in.mp4"
    write_video(source)
    port, port_written = read_write("torch", tmp_path, source)
    reference, reference_written = read_write("jax", tmp_path, source)
    assert len(port) == len(reference) == 5
    assert port_written == reference_written == 5
    for got, want in zip(port, reference):
        assert got.shape == (48, 64, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def tracker_script(seed, frames=40):
    """Boxes for `frames` frames: objects drift, vanish for a few frames
    (ageing, then death past max_age), new ones are born, and two
    overlap (a greedy match by IoU order)."""
    rng = np.random.default_rng(seed)
    objects = [rng.uniform(0, 200, 2) for _ in range(4)]
    script = []
    for t in range(frames):
        boxes = []
        for i, (x, y) in enumerate(objects):
            if (t + 3 * i) % 11 in (5, 6, 7) and i != 0:
                continue                       # hidden: the track ages
            size = 20 + 4 * i
            boxes.append([float(x), float(y), float(x + size),
                          float(y + size)])
        if t % 9 == 4:
            boxes.append([float(v) for v in rng.uniform(0, 240, 2)] +
                         [250.0, 250.0])       # a one-frame birth
        script.append(boxes)
        objects = [(x + rng.normal(0, 2), y + rng.normal(0, 2))
                   for x, y in objects]
        if t == 20:
            objects.append(objects[1] + np.array([3.0, 3.0]))
    return script


def track(package, script, max_age):
    engine, pipeline = build(
        package, f"p_trk_{package}", "(PE_Tracker)",
        [element("PE_Tracker", ["boxes"], ["tracks"],
                 {"max_age": max_age})])
    pipeline.create_stream("s1", lease_time=0)
    out = []
    for boxes in script:
        ok, swag = pipeline.process_frame("s1", {"boxes": boxes})
        assert ok
        out.append(swag["tracks"])
    node = pipeline.graph.node("PE_Tracker")
    tracks = pipeline.streams["s1"].variables["PE_Tracker.tracks"]
    return out, {k: dict(v) for k, v in tracks.items()}, node


@pytest.mark.parametrize("seed,max_age", [(0, 1), (1, 5), (2, 2)])
def test_tracker_scripts_equal_jax(seed, max_age):
    script = tracker_script(seed)
    port, port_tracks, _ = track("torch", script, max_age)
    reference, reference_tracks, _ = track("jax", script, max_age)
    assert port == reference
    assert port_tracks == reference_tracks
    ids = {t["track_id"] for frame in port for t in frame}
    assert len(ids) > 4                        # births beyond the first


def test_tracker_stable_ids_and_expiry():
    """tests/test_media.py's script on the port."""
    engine, pipeline = build(
        "torch", "p_trk", "(PE_Tracker)",
        [element("PE_Tracker", ["boxes"], ["tracks"], {"max_age": 1})])
    pipeline.create_stream("s1", lease_time=0)
    ok, swag = pipeline.process_frame(
        "s1", {"boxes": [[0, 0, 10, 10], [50, 50, 80, 80]]})
    ids0 = {tuple(t["box"]): t["track_id"] for t in swag["tracks"]}
    assert len(set(ids0.values())) == 2
    ok, swag = pipeline.process_frame(
        "s1", {"boxes": [[2, 2, 12, 12], [52, 52, 82, 82]]})
    assert {t["track_id"] for t in swag["tracks"]} == set(ids0.values())
    pipeline.process_frame("s1", {"boxes": []})
    pipeline.process_frame("s1", {"boxes": []})
    ok, swag = pipeline.process_frame("s1", {"boxes": [[0, 0, 10, 10]]})
    assert swag["tracks"][0]["track_id"] not in set(ids0.values())


def marked_image(value: int = 0):
    image = np.zeros((48, 64, 3), np.uint8)
    image[:, :, 0] = value                     # red channel encodes id
    image[8:16, 8:16] = 255
    return image


def test_jpeg_round_trip_matches_jax():
    image = marked_image(200)
    data = TVS.encode_jpeg(image, quality=95)
    assert data == JVS.encode_jpeg(image, quality=95)
    decoded = TVS.decode_jpeg(data)
    np.testing.assert_array_equal(decoded, JVS.decode_jpeg(data))
    assert decoded.shape == image.shape
    assert abs(int(decoded[24, 40, 0]) - 200) < 20
    with pytest.raises(ValueError, match="decode"):
        TVS.decode_jpeg(b"not a jpeg")


def test_mjpeg_server_serves_latest_frame():
    server = TVS.MJPEGStreamServer()
    stop = threading.Event()

    def publisher():
        while not stop.is_set():
            server.publish(TVS.encode_jpeg(marked_image(10)))
            time.sleep(0.01)

    thread = threading.Thread(target=publisher, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(server.url, timeout=5.0) as response:
            assert "multipart/x-mixed-replace" in \
                response.headers["Content-Type"]
            payload = response.read(4096)
        assert b"image/jpeg" in payload
        assert server.clients_served == 1
    finally:
        stop.set()
        thread.join(timeout=2.0)
        server.close()


def test_stream_read_ingests_mjpeg_over_http():
    server = TVS.MJPEGStreamServer()
    received = []
    engine, pipeline = build(
        "torch", "p_ingest", "(PE_VideoStreamRead (PE_Collect))",
        [element("PE_VideoStreamRead", [], ["image"]),
         element("PE_Collect", ["image"], [])],
        {"PE_VideoStreamRead.url": server.url,
         "PE_VideoStreamRead.rate": 50.0},
        collector("torch", received))
    pipeline.create_stream("s1", lease_time=0)
    deadline = time.monotonic() + 20.0
    while len(received) < 3 and time.monotonic() < deadline:
        server.publish(TVS.encode_jpeg(marked_image(120)))
        engine.clock.advance(0.02)
        engine.step()
        time.sleep(0.01)
    server.close()
    pipeline.destroy_stream("s1")
    assert len(received) >= 3, "stream reader never delivered frames"
    assert received[0].shape == (48, 64, 3)
    assert abs(int(received[-1][24, 40, 0]) - 120) < 25


def test_h264_file_egress_and_a_failed_open(tmp_path):
    engine, pipeline = build(
        "torch", "p_write", "(PE_VideoStreamWrite)",
        [element("PE_VideoStreamWrite", ["image"], [])],
        {"PE_VideoStreamWrite.fps": 10.0})
    pipeline.create_stream("bad", lease_time=0, parameters={
        "PE_VideoStreamWrite.url": str(tmp_path / "no_such_dir" / "x.mp4"),
        "PE_VideoStreamWrite.fourcc": "zzzz",
        "PE_VideoStreamWrite.fourcc_fallback": "zzzz"})
    ok, _ = pipeline.process_frame("bad", {"image": marked_image(1)})
    assert not ok
    pipeline.destroy_stream("bad")
    out = str(tmp_path / "egress.mp4")
    pipeline.create_stream("w1", lease_time=0, parameters={
        "PE_VideoStreamWrite.url": out})
    for i in range(12):
        ok, _ = pipeline.process_frame("w1", {"image": marked_image(60 + i)})
        assert ok
    pipeline.destroy_stream("w1")
    capture = cv2.VideoCapture(out)
    frames = []
    while True:
        ok, bgr = capture.read()
        if not ok:
            break
        frames.append(bgr[:, :, ::-1])
    capture.release()
    assert len(frames) >= 10
    assert int(frames[0][12, 12].mean()) > 180


def udp_receiver(name, parameters=None):
    received = []
    engine, receiver = build(
        "torch", name, "(PE_VideoUDPReceive (PE_Collect))",
        [element("PE_VideoUDPReceive", [], ["image"]),
         element("PE_Collect", ["image"], [])],
        {"PE_VideoUDPReceive.rate": 100.0, **(parameters or {})},
        collector("torch", received))
    receiver.create_stream("rx", lease_time=0)
    rx_element = receiver.graph.node("PE_VideoUDPReceive").element
    port = int(rx_element.ec_producer.get("udp_port"))
    assert port

    def pump_until(count, budget=10.0):
        deadline = time.monotonic() + budget
        while len(received) < count and time.monotonic() < deadline:
            engine.clock.advance(0.01)
            engine.step()
            time.sleep(0.005)
        assert len(received) >= count, \
            f"{len(received)}/{count} frames delivered"

    return engine, receiver, port, received, pump_until


def test_udp_send_receive_loopback():
    engine, receiver, port, received, pump_until = udp_receiver("p_rx")
    _, sender = build("torch", "p_tx", "(PE_VideoUDPSend)",
                      [element("PE_VideoUDPSend", ["image"], [])],
                      {"PE_VideoUDPSend.port": port})
    sender.create_stream("tx", lease_time=0)
    # a large frame: the jpeg spans several datagrams
    big = np.random.default_rng(0).integers(
        0, 255, (480, 640, 3), dtype=np.uint8)
    deadline = time.monotonic() + 15.0
    while len(received) < 2 and time.monotonic() < deadline:
        sender.process_frame("tx", {"image": big})
        engine.clock.advance(0.02)
        engine.step()
        time.sleep(0.01)
    sender.destroy_stream("tx")
    receiver.destroy_stream("rx")
    assert len(received) >= 2, "udp frames never arrived"
    assert received[0].shape == (480, 640, 3)


def parts_for(frame_id, image, chunk=1000):
    payload = TVS.encode_jpeg(image, 80)
    chunks = [payload[i:i + chunk] for i in range(0, len(payload), chunk)]
    return [(TVS._UDP_HEADER.pack(frame_id, part, len(chunks)) + data)
            for part, data in enumerate(chunks)]


def test_udp_receive_survives_loss_reorder_and_interleaving():
    engine, receiver, port, received, pump_until = udp_receiver(
        "p_rx2", {"PE_VideoUDPReceive.latency_ms": 200.0})
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    address = ("127.0.0.1", port)
    rng = np.random.default_rng(3)
    img1 = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    img2 = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    f1, f2, f3 = parts_for(1, img1), parts_for(2, img2), parts_for(3, img1)
    assert len(f1) >= 3, "need multi-part frames for this test"
    # frame 1 reversed, frame 2's parts interleaved, frame 2's tail held
    # back; frame 3 loses a part; then a late copy of frame 1
    wire = []
    for a, b in zip(reversed(f1), f2[:-1]):
        wire += [a, b]
    wire += f1[::-1][len(f2) - 1:] + f2[len(f1):-1]
    for datagram in wire:
        sock.sendto(datagram, address)
    pump_until(1)
    sock.sendto(f2[-1], address)
    pump_until(2)
    for datagram in f3[:-1]:
        sock.sendto(datagram, address)
    for datagram in parts_for(1, img2):
        sock.sendto(datagram, address)
    time.sleep(0.3)
    before = len(received)
    for _ in range(20):
        engine.clock.advance(0.01)
        engine.step()
    state = receiver.streams["rx"].variables["PE_VideoUDPReceive.state"]
    assert state["stats"]["complete"] == 2
    assert state["stats"]["late"] >= 1
    deadline = time.monotonic() + 2.0
    while state["stats"]["incomplete"] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert state["stats"]["incomplete"] >= 1
    assert len(received) == before                 # no backwards step
    receiver.destroy_stream("rx")
    sock.close()


def test_udp_receive_resyncs_after_sender_restart():
    engine, receiver, port, received, pump_until = udp_receiver("p_rx3")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    address = ("127.0.0.1", port)
    img = np.random.default_rng(5).integers(0, 255, (32, 32, 3),
                                            dtype=np.uint8)

    def send_frame(frame_id):
        payload = TVS.encode_jpeg(img, 80)
        sock.sendto(TVS._UDP_HEADER.pack(frame_id, 0, 1) + payload, address)

    send_frame(50_000)               # a long-running sender
    pump_until(1)
    send_frame(1)                    # restarted: ids reset
    send_frame(2)
    pump_until(2)
    receiver.destroy_stream("rx")
    sock.close()
