# Streaming video I/O: network ingest and egress.
#
# Counterpart of aiko_services_tpu/elements/video_stream.py, host code
# only (OpenCV, imported inside the calls that need it, and the standard
# library):
#   * PE_VideoStreamRead — URL ingest (rtsp:// udp:// http:// ...)
#     through OpenCV's FFMPEG backend, with reconnect + exponential
#     backoff and drop-to-latest real-time semantics: a live pipeline
#     wants the newest frame, not a backlog.
#   * MJPEGStreamServer / PE_VideoStreamServe — HTTP multipart-MJPEG
#     egress (stdlib http.server): any browser, OpenCV, or ffmpeg client
#     can consume it.
#   * PE_VideoStreamWrite — H.264 egress to a file (cv2.VideoWriter) or a
#     network URL (an ffmpeg subprocess fed raw RGB).
#   * PE_VideoUDPSend / PE_VideoUDPReceive — low-latency JPEG-over-UDP
#     with a tiny chunking header (frame, part, count) and a jitter
#     buffer; datagram loss drops that frame only.

from __future__ import annotations

import socket
import struct
import threading
import time

from ..pipeline import Frame, FrameOutput, PipelineElement
from ..utils import Lock, get_logger

__all__ = ["PE_VideoStreamRead", "PE_VideoStreamServe", "MJPEGStreamServer",
           "PE_VideoStreamWrite",
           "PE_VideoUDPSend", "PE_VideoUDPReceive", "encode_jpeg",
           "decode_jpeg"]

_BOUNDARY = "aikoframe"


def encode_jpeg(image_rgb, quality: int = 80) -> bytes:
    import cv2
    import numpy as np

    bgr = np.asarray(image_rgb).astype("uint8")[:, :, ::-1]
    ok, data = cv2.imencode(".jpg", bgr,
                            [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        raise ValueError("jpeg encode failed")
    return data.tobytes()


def decode_jpeg(data: bytes):
    import cv2
    import numpy as np

    bgr = cv2.imdecode(np.frombuffer(data, "uint8"), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("jpeg decode failed")
    return bgr[:, :, ::-1]


class PE_VideoStreamRead(PipelineElement):
    """Network stream source: `url` parameter (rtsp://, udp://, http://
    MJPEG, ...) decoded by OpenCV/FFMPEG on a capture thread.

    Real-time semantics: the capture thread always overwrites the latest
    frame; a timer emits it at `rate` — a slow pipeline sees fresh frames,
    never a stale backlog.  Lost connections reconnect with exponential
    backoff (`backoff` initial seconds, doubling to `backoff_limit`)."""

    def start_stream(self, stream) -> None:
        url, found = self.get_parameter("url", stream=stream)
        if not found:
            raise ValueError(f"{self.name}: no url parameter")
        rate, _ = self.get_parameter("rate", 20.0, stream)
        backoff, _ = self.get_parameter("backoff", 0.5, stream)
        backoff_limit, _ = self.get_parameter("backoff_limit", 8.0, stream)
        logger = get_logger(f"videostream.{self.name}")
        state = {"latest": None, "stop": False, "connected": False,
                 "reconnects": -1,       # first connect isn't a reconnect
                 "lock": Lock(f"videostream.{self.name}")}
        stream.variables[f"{self.definition.name}.state"] = state

        def capture_loop():
            import cv2

            delay = float(backoff)
            while not state["stop"]:
                capture = cv2.VideoCapture(str(url))
                if not capture.isOpened():
                    capture.release()
                    state["connected"] = False
                    logger.warning("%s: cannot open %s; retry in %.1fs",
                                   self.name, url, delay)
                    time.sleep(delay)
                    delay = min(delay * 2, float(backoff_limit))
                    continue
                state["connected"] = True
                state["reconnects"] += 1
                delay = float(backoff)           # healthy: reset backoff
                while not state["stop"]:
                    ok, bgr = capture.read()
                    if not ok:
                        break                    # EOF / connection lost
                    with state["lock"]:
                        state["latest"] = bgr[:, :, ::-1]
                capture.release()
                state["connected"] = False

        state["thread"] = threading.Thread(
            target=capture_loop, name=f"{self.name}.capture", daemon=True)
        state["thread"].start()

        def tick():
            # locked read-and-clear: a frame stored between an unlocked
            # read and the clear would be silently dropped
            with state["lock"]:
                latest = state["latest"]
                state["latest"] = None           # emit each frame once
            if latest is not None:
                self.create_frame(stream, {"image": latest})

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, 1.0 / float(rate))

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            state["stop"] = True
            self.runtime.event.remove_timer_handler(state["timer"])

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})


class MJPEGStreamServer:
    """Minimal multipart-MJPEG HTTP server (stdlib only).

    publish(jpeg_bytes) hands every connected client the newest frame;
    slow clients skip frames rather than queueing them."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import http.server

        server_self = self
        self._condition = threading.Condition()
        self._frame: bytes | None = None
        self._sequence = 0
        self.clients_served = 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                    # noqa: N802 (stdlib API)
                server_self.clients_served += 1
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={_BOUNDARY}")
                self.end_headers()
                last_sequence = -1
                try:
                    while True:
                        with server_self._condition:
                            server_self._condition.wait_for(
                                lambda: server_self._sequence !=
                                last_sequence or server_self._closing,
                                timeout=5.0)
                            if server_self._closing:
                                return
                            frame = server_self._frame
                            last_sequence = server_self._sequence
                        if frame is None:
                            continue
                        self.wfile.write(
                            f"--{_BOUNDARY}\r\nContent-Type: image/jpeg"
                            f"\r\nContent-Length: {len(frame)}"
                            f"\r\n\r\n".encode())
                        self.wfile.write(frame)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return

            def log_message(self, *args):        # quiet
                pass

        import http.server as hs
        self._closing = False
        self.server = hs.ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://{host}:{self.port}/stream.mjpg"
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="mjpeg.server", daemon=True)
        self._thread.start()

    def publish(self, jpeg: bytes) -> None:
        with self._condition:
            self._frame = jpeg
            self._sequence += 1
            self._condition.notify_all()

    def close(self) -> None:
        with self._condition:
            self._closing = True
            self._condition.notify_all()
        self.server.shutdown()
        self.server.server_close()


class PE_VideoStreamServe(PipelineElement):
    """Egress sink: serves the pipeline's frames as HTTP multipart-MJPEG
    (parameter `port`, 0 = ephemeral; the bound URL lands in the EC share
    as `stream_url`)."""

    def start_stream(self, stream) -> None:
        port, _ = self.get_parameter("port", 0, stream)
        quality, _ = self.get_parameter("quality", 80, stream)
        server = MJPEGStreamServer(port=int(port))
        stream.variables[f"{self.definition.name}.server"] = server
        stream.variables[f"{self.definition.name}.quality"] = int(quality)
        self.ec_producer.update("stream_url", server.url)

    def stop_stream(self, stream) -> None:
        server = stream.variables.get(f"{self.definition.name}.server")
        if server is not None:
            server.close()

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        server = frame.stream.variables[f"{self.definition.name}.server"]
        quality = frame.stream.variables[f"{self.definition.name}.quality"]
        server.publish(encode_jpeg(image, quality))
        return FrameOutput(True, {})


class PE_VideoStreamWrite(PipelineElement):
    """H.264 egress sink (x264 with zerolatency tuning).

    Parameter `url` decides the transport:
      * file targets (*.mp4, *.mkv, *.avi) → cv2.VideoWriter via the
        FFMPEG backend, fourcc parameter (default "avc1" = H.264,
        falling back per `fourcc_fallback`, default "mp4v");
      * rtsp:// rtmp:// udp:// → an ffmpeg subprocess fed raw RGB on
        stdin encoding libx264 `-preset ultrafast -tune zerolatency`
        (OpenCV's writer cannot push network streams).
    The first frame fixes the stream geometry; fps via parameter `fps`.
    The EC share reports `write_url` and `write_backend`."""

    def start_stream(self, stream) -> None:
        stream.variables[f"{self.definition.name}.state"] = {
            "writer": None, "proc": None, "size": None,
            "frames_written": 0}

    def _open(self, stream, width: int, height: int) -> dict:
        state = stream.variables[f"{self.definition.name}.state"]
        url, found = self.get_parameter("url", stream=stream)
        if not found:
            raise ValueError(f"{self.name}: no url parameter")
        url = str(url)
        fps, _ = self.get_parameter("fps", 20.0, stream)
        fps = float(fps)
        logger = get_logger(f"videowrite.{self.name}")
        if url.split("://", 1)[0] in ("rtsp", "rtmp", "udp", "tcp"):
            import subprocess
            sink = {"rtsp": ["-f", "rtsp", "-rtsp_transport", "tcp"],
                    "rtmp": ["-f", "flv"],
                    "udp": ["-f", "mpegts"],
                    "tcp": ["-f", "mpegts"]}[url.split("://", 1)[0]]
            command = [
                "ffmpeg", "-loglevel", "error", "-f", "rawvideo",
                "-pix_fmt", "rgb24", "-s", f"{width}x{height}",
                "-r", f"{fps}", "-i", "-",
                "-c:v", "libx264", "-preset", "ultrafast",
                "-tune", "zerolatency", "-pix_fmt", "yuv420p",
                *sink, url]
            state["proc"] = subprocess.Popen(
                command, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            backend = "ffmpeg-libx264"
        else:
            import cv2
            fourcc, _ = self.get_parameter("fourcc", "avc1", stream)
            fallback, _ = self.get_parameter("fourcc_fallback", "mp4v",
                                             stream)
            writer = cv2.VideoWriter(
                url, cv2.VideoWriter_fourcc(*str(fourcc)), fps,
                (width, height))
            backend = f"cv2-{fourcc}"
            if not writer.isOpened():
                writer.release()
                writer = cv2.VideoWriter(
                    url, cv2.VideoWriter_fourcc(*str(fallback)), fps,
                    (width, height))
                backend = f"cv2-{fallback}"
                logger.warning("%s: fourcc %s unavailable, using %s",
                               self.name, fourcc, fallback)
            if not writer.isOpened():
                raise RuntimeError(f"{self.name}: cannot open {url}")
            state["writer"] = writer
        # size set LAST: a failed open must leave the state un-poisoned
        # so the next frame reports the real error (and can retry)
        state["size"] = (width, height)
        self.ec_producer.update("write_url", url)
        self.ec_producer.update("write_backend", backend)
        return state

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        import numpy as np

        rgb = np.ascontiguousarray(np.asarray(image).astype("uint8"))
        state = frame.stream.variables[f"{self.definition.name}.state"]
        if state["size"] is None:
            try:
                # first-frame egress open: the encoder spawn is the
                # sanctioned lazy-init seam (size is only known here)
                state = self._open(frame.stream, rgb.shape[1],  # graft: disable=lint-blocking-call
                                   rgb.shape[0])
            except Exception as exc:
                return FrameOutput(False,
                                   diagnostic=f"egress open: {exc!r}")
        if (rgb.shape[1], rgb.shape[0]) != state["size"]:
            return FrameOutput(False, diagnostic=(
                f"frame {rgb.shape[1]}x{rgb.shape[0]} != stream "
                f"{state['size'][0]}x{state['size'][1]}"))
        if state["proc"] is not None:
            if state["proc"].poll() is not None:
                return FrameOutput(False,
                                   diagnostic="ffmpeg egress died")
            try:
                state["proc"].stdin.write(rgb.tobytes())
            except BrokenPipeError:
                return FrameOutput(False,
                                   diagnostic="ffmpeg egress pipe broke")
        else:
            state["writer"].write(rgb[:, :, ::-1])       # RGB → BGR
        state["frames_written"] += 1
        return FrameOutput(True, {})

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if not state:
            return
        if state.get("writer") is not None:
            state["writer"].release()
        proc = state.get("proc")
        if proc is not None:
            # close stdin separately: a broken pipe here must not stop
            # a healthy ffmpeg from finalizing the container mux
            try:
                proc.stdin.close()
            except Exception:
                pass
            try:
                proc.wait(timeout=10.0)
            except Exception:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)   # reap; never leave a zombie
                except Exception:
                    pass


# -- JPEG over UDP -----------------------------------------------------------
# datagram = header(frame_id u32, part u16, part_count u16) + jpeg chunk
_UDP_HEADER = struct.Struct("!IHH")
_UDP_CHUNK = 60000                  # stay under the 64 KiB datagram cap
# assembly-state bounds for the open UDP port: a flood of datagrams
# with distinct frame ids (each claiming a large part count) must not
# grow per-frame state without limit.  128 parts × 60 KB ≈ 7.7 MB caps
# a single frame far above any sane JPEG; 64 concurrent frames bounds
# the jitter window's working set (oldest assembly evicted first).
_UDP_MAX_PARTS = 128
_UDP_MAX_PENDING = 64


class PE_VideoUDPSend(PipelineElement):
    """Low-latency egress: JPEG frames chunked over UDP to host:port."""

    def start_stream(self, stream) -> None:
        state = {
            "socket": socket.socket(socket.AF_INET, socket.SOCK_DGRAM),
            "frame_id": 0,
        }
        stream.variables[f"{self.definition.name}.state"] = state

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            state["socket"].close()

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        host, _ = self.get_parameter("host", "127.0.0.1", frame.stream)
        port, found = self.get_parameter("port", stream=frame.stream)
        if not found:
            return FrameOutput(False, diagnostic="no port parameter")
        quality, _ = self.get_parameter("quality", 80, frame.stream)
        state = frame.stream.variables[f"{self.definition.name}.state"]
        payload = encode_jpeg(image, int(quality))
        chunks = [payload[i:i + _UDP_CHUNK]
                  for i in range(0, len(payload), _UDP_CHUNK)] or [b""]
        frame_id = state["frame_id"] = (state["frame_id"] + 1) & 0xFFFFFFFF
        address = (str(host), int(port))
        for part, chunk in enumerate(chunks):
            header = _UDP_HEADER.pack(frame_id, part, len(chunks))
            state["socket"].sendto(header + chunk, address)
        return FrameOutput(True, {})


def _frame_id_newer(a: int, b: int) -> bool:
    """True when frame id `a` is newer than `b` under u32 wraparound."""
    return ((a - b) & 0xFFFFFFFF) < 0x80000000


class PE_VideoUDPReceive(PipelineElement):
    """Source: reassembles JPEG-over-UDP frames from PE_VideoUDPSend
    through a JITTER BUFFER — datagrams may arrive reordered, delayed,
    interleaved across frames, or not at all.

    Per-frame assembly buffers tolerate cross-frame interleaving and
    out-of-order parts; a frame older than `latency_ms` that never
    completed is purged (counted `udp_incomplete`), and a frame that
    completes AFTER a newer frame was already delivered is dropped
    (`udp_late`) — live semantics never step backwards.  Parameter
    `port` (0 = ephemeral; bound port lands in the EC share as
    `udp_port`)."""

    def start_stream(self, stream) -> None:
        port, _ = self.get_parameter("port", 0, stream)
        latency_ms, _ = self.get_parameter("latency_ms", 50.0, stream)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", int(port)))
        sock.settimeout(0.25)
        state = {"socket": sock, "stop": False, "latest": None,
                 "stats": {"complete": 0, "incomplete": 0, "late": 0}}
        stream.variables[f"{self.definition.name}.state"] = state
        self.ec_producer.update("udp_port", sock.getsockname()[1])
        window = float(latency_ms) / 1000.0

        def receive_loop():
            import time as _time
            pending: dict = {}       # frame_id -> {parts, count, t0}
            delivered = None         # newest frame_id handed over
            stale_run = 0            # consecutive not-newer FRAMES
            last_stale = None
            while not state["stop"]:
                try:
                    datagram = sock.recv(65535)
                except socket.timeout:
                    datagram = None
                except OSError:
                    return
                now = _time.monotonic()
                if datagram is not None and \
                        len(datagram) >= _UDP_HEADER.size:
                    frame_id, part, count = _UDP_HEADER.unpack(
                        datagram[:_UDP_HEADER.size])
                    if count == 0 or part >= count or \
                            count > _UDP_MAX_PARTS:
                        # corrupt/hostile header: an out-of-range part
                        # would satisfy the length==count completion
                        # check while leaving a hole for the join, and
                        # an absurd part count would reserve unbounded
                        # assembly state
                        state["stats"]["incomplete"] += 1
                        continue
                    stale = delivered is not None and (
                        frame_id == delivered or
                        not _frame_id_newer(frame_id, delivered))
                    if stale:
                        state["stats"]["late"] += 1
                        # count stale FRAMES, not datagrams: one late
                        # multi-part frame must not masquerade as a
                        # sender restart
                        if frame_id != last_stale:
                            stale_run += 1
                            last_stale = frame_id
                        # a RESTARTED sender counts from 1 again — a
                        # large backwards jump, or a sustained run of
                        # "late" traffic, is a new stream, not jitter;
                        # resync instead of freezing until the new ids
                        # catch up (the pre-jitter-buffer code resynced
                        # on any id change)
                        backwards = (delivered - frame_id) & 0xFFFFFFFF
                        if backwards > 4096 or stale_run > 32:
                            delivered = None
                            pending.clear()
                            stale_run = 0
                            last_stale = None
                    else:
                        stale_run = 0
                        last_stale = None
                        if frame_id not in pending and \
                                len(pending) >= _UDP_MAX_PENDING:
                            # cap concurrent assemblies: evict the
                            # oldest — under a frame-id flood the
                            # newest ids are the live stream
                            oldest = min(pending,
                                         key=lambda f: pending[f]["t0"])
                            del pending[oldest]
                            state["stats"]["incomplete"] += 1
                        entry = pending.setdefault(
                            frame_id, {"parts": {}, "count": count,
                                       "t0": now})
                        if part >= entry["count"]:
                            # headers disagree across datagrams of one
                            # frame id — drop rather than corrupt
                            continue
                        entry["parts"][part] = \
                            datagram[_UDP_HEADER.size:]
                        if len(entry["parts"]) == entry["count"]:
                            data = b"".join(
                                entry["parts"][i]
                                for i in range(entry["count"]))
                            del pending[frame_id]
                            try:
                                state["latest"] = decode_jpeg(data)
                                state["stats"]["complete"] += 1
                                delivered = frame_id
                                # frames older than the delivered one
                                # can never be shown — purge them
                                for stale in [f for f in pending
                                              if not _frame_id_newer(
                                                  f, frame_id)]:
                                    del pending[stale]
                                    state["stats"]["incomplete"] += 1
                            except ValueError:
                                state["stats"]["incomplete"] += 1
                # age out frames whose missing parts exceeded the
                # jitter window — they are loss, not jitter
                for stale in [f for f, e in pending.items()
                              if now - e["t0"] > window]:
                    del pending[stale]
                    state["stats"]["incomplete"] += 1

        state["thread"] = threading.Thread(
            target=receive_loop, name=f"{self.name}.udp", daemon=True)
        state["thread"].start()

        rate, _ = self.get_parameter("rate", 20.0, stream)

        def tick():
            latest = state["latest"]
            if latest is not None:
                state["latest"] = None
                self.create_frame(stream, {"image": latest})
            for key, value in state["stats"].items():
                share_key = f"udp_{key}"
                if self.ec_producer.get(share_key) != value:
                    self.ec_producer.update(share_key, value)

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, 1.0 / float(rate))

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            state["stop"] = True
            self.runtime.event.remove_timer_handler(state["timer"])
            state["socket"].close()

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})
