# Video elements: file and camera I/O, display, and tracking.
#
# Counterpart of aiko_services_tpu/elements/video.py: host code on OpenCV
# (imported inside the calls that need it).  File read and write and
# camera capture ride OpenCV; PE_VideoShow counts frames when no display
# is present.  PE_Tracker is the greedy IoU multi-object tracker of the
# video → detect → tracker pipeline (BASELINE.md config 4): track ids,
# births, matches, ageing and deaths follow the JAX element's order.

from __future__ import annotations

from ..pipeline import Frame, FrameOutput, PipelineElement

__all__ = ["PE_VideoReadFile", "PE_VideoWriteFile", "PE_VideoCameraRead",
           "PE_VideoShow", "PE_Tracker"]


class PE_VideoReadFile(PipelineElement):
    """Source: decodes a video file, one frame per timer tick at the
    requested rate (parameters pathname, rate 20.0); at the end of the
    file the stream is destroyed once no frame it read is still in the
    pipeline."""

    contracts = {"out:image": "u8[*,*,3]"}

    def start_stream(self, stream) -> None:
        import cv2

        pathname, found = self.get_parameter("pathname", stream=stream)
        if not found:
            raise ValueError(f"{self.name}: no pathname parameter")
        rate, _ = self.get_parameter("rate", 20.0, stream)
        capture = cv2.VideoCapture(str(pathname))
        if not capture.isOpened():
            raise ValueError(f"{self.name}: cannot open {pathname}")
        state = {"capture": capture, "read": 0}
        stream.variables[f"{self.definition.name}.state"] = state
        period = 1.0 / float(rate)

        def tick():
            ok, bgr = capture.read()
            if not ok:
                # end of file: stop reading; the stream goes once every
                # frame read has entered the pipeline and none is parked
                # DEFERRED downstream (the JAX element destroys it at
                # once, and a parked frame's result is lost)
                self.runtime.event.remove_timer_handler(state["timer"])
                state["timer"] = self.runtime.event.add_timer_handler(
                    drained, period, immediate=True)
                return
            state["read"] += 1
            self.create_frame(stream, {"image": bgr[:, :, ::-1]})  # RGB

        def drained():
            if stream.frame_id >= state["read"] and not stream.parked:
                self.runtime.event.remove_timer_handler(state["timer"])
                if self.pipeline is not None:
                    self.pipeline.post("destroy_stream", stream.stream_id)

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, period, immediate=True)

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            self.runtime.event.remove_timer_handler(state["timer"])
            state["capture"].release()

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})


class PE_VideoWriteFile(PipelineElement):
    """Sink: encodes frames to a video file (mp4v; parameters pathname,
    which may name {stream_id}, and rate 20.0)."""

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        import cv2
        import numpy as np

        key = f"{self.definition.name}.writer"
        writer = frame.stream.variables.get(key)
        image = np.asarray(image).astype("uint8")
        if writer is None:
            pathname, found = self.get_parameter("pathname",
                                                 stream=frame.stream)
            if not found:
                return FrameOutput(False, diagnostic="no pathname")
            rate, _ = self.get_parameter("rate", 20.0, frame.stream)
            pathname = str(pathname).format(stream_id=frame.stream_id)
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            writer = cv2.VideoWriter(
                pathname, fourcc, float(rate),
                (image.shape[1], image.shape[0]))
            frame.stream.variables[key] = writer
        writer.write(image[:, :, ::-1])            # RGB → BGR
        return FrameOutput(True, {})

    def stop_stream(self, stream) -> None:
        writer = stream.variables.get(f"{self.definition.name}.writer")
        if writer is not None:
            writer.release()


class PE_VideoCameraRead(PipelineElement):
    """Camera source (v4l2 via OpenCV; parameters device 0, rate 20.0):
    raises at stream start when no camera opens."""

    def start_stream(self, stream) -> None:
        import cv2

        device, _ = self.get_parameter("device", 0, stream)
        rate, _ = self.get_parameter("rate", 20.0, stream)
        capture = cv2.VideoCapture(int(device))
        if not capture.isOpened():
            raise RuntimeError(f"{self.name}: no camera at {device}; use "
                               f"PE_VideoReadFile for file input")
        state = {"capture": capture}
        stream.variables[f"{self.definition.name}.state"] = state

        def tick():
            ok, bgr = capture.read()
            if ok:
                self.create_frame(stream, {"image": bgr[:, :, ::-1]})

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, 1.0 / float(rate))

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            self.runtime.event.remove_timer_handler(state["timer"])
            state["capture"].release()

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})


class PE_VideoShow(PipelineElement):
    """Display sink: counts frames in the stream variable
    "video_show.count" when no display is present."""

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        import numpy as np

        try:
            import cv2
            cv2.imshow(self.name, np.asarray(image)[:, :, ::-1])
            cv2.waitKey(1)
        except Exception:
            # headless: count frames instead of displaying
            shown = frame.stream.variables.get("video_show.count", 0)
            frame.stream.variables["video_show.count"] = shown + 1
        return FrameOutput(True, {})


class PE_Tracker(PipelineElement):
    """Greedy IoU multi-object tracker: assigns stable track ids to
    per-frame detection boxes [x1, y1, x2, y2] (parameters iou_threshold
    0.3, max_age 5).  Tracks expire after `max_age` frames unmatched."""

    def start_stream(self, stream) -> None:
        stream.variables[f"{self.definition.name}.tracks"] = {}
        stream.variables[f"{self.definition.name}.next_id"] = 0

    @staticmethod
    def _iou(a, b) -> float:
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
        inter = iw * ih
        area_a = (a[2] - a[0]) * (a[3] - a[1])
        area_b = (b[2] - b[0]) * (b[3] - b[1])
        union = area_a + area_b - inter
        return inter / union if union > 0 else 0.0

    def process_frame(self, frame: Frame, boxes=None, **_) -> FrameOutput:
        iou_threshold, _ = self.get_parameter("iou_threshold", 0.3,
                                              frame.stream)
        max_age, _ = self.get_parameter("max_age", 5, frame.stream)
        prefix = self.definition.name
        tracks = frame.stream.variables[f"{prefix}.tracks"]
        boxes = [list(map(float, box)) for box in (boxes or [])]

        # greedy match: highest IoU first
        candidates = []
        for track_id, track in tracks.items():
            for index, box in enumerate(boxes):
                iou = self._iou(track["box"], box)
                if iou >= float(iou_threshold):
                    candidates.append((iou, track_id, index))
        candidates.sort(reverse=True)
        matched_tracks, matched_boxes = set(), set()
        assignments = {}
        for iou, track_id, index in candidates:
            if track_id in matched_tracks or index in matched_boxes:
                continue
            matched_tracks.add(track_id)
            matched_boxes.add(index)
            assignments[index] = track_id
            tracks[track_id] = {"box": boxes[index], "age": 0}

        for index, box in enumerate(boxes):         # births
            if index not in matched_boxes:
                track_id = frame.stream.variables[f"{prefix}.next_id"]
                frame.stream.variables[f"{prefix}.next_id"] = track_id + 1
                tracks[track_id] = {"box": box, "age": 0}
                assignments[index] = track_id

        for track_id in list(tracks):               # deaths
            if track_id not in matched_tracks and \
                    track_id not in assignments.values():
                tracks[track_id]["age"] += 1
                if tracks[track_id]["age"] > int(max_age):
                    del tracks[track_id]

        tracked = [{"track_id": assignments[i], "box": boxes[i]}
                   for i in range(len(boxes))]
        return FrameOutput(True, {"tracks": tracked})
