"""Explode a video file into numbered images through the port's
pipeline: the port's copy of examples/pipeline/video_to_images.py
(reference parity: examples/pipeline/video_to_images.py, which runs
VideoReadFile → ImageOverlay → ImageWriteFile on the 2020 pipeline).

Usage:
    python -m aiko_services_tpu_torch.examples.pipeline.video_to_images \
        input.mp4 "out/image_{frame:06d}.jpg" [--overlay]

Runs flat-out (rate=0 semantics: frames post as fast as they complete),
entirely in-process on the memory transport.
"""

# an example script: its console lines are its output
# graft: disable-file=lint-print

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("video")
    parser.add_argument("image_pattern",
                        help='e.g. "out/image_{frame:06d}.jpg"')
    parser.add_argument("--overlay", action="store_true",
                        help="draw the frame-id overlay before writing")
    parser.add_argument("--rate", type=float, default=200.0)
    args = parser.parse_args(argv)

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.pipeline import (
        FrameOutput, Pipeline, PipelineElement, parse_pipeline_definition)
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport.memory import (MemoryBroker,
                                                          MemoryMessage)

    os.makedirs(os.path.dirname(args.image_pattern) or ".", exist_ok=True)

    class PE_NumberedWrite(PipelineElement):
        """ImageWriteFile with the reference's numbered-pathname
        behavior (image_{:06d}.jpg)."""

        def process_frame(self, frame, image=None, **_):
            from PIL import Image
            import numpy as np
            pathname = args.image_pattern.format(frame=frame.frame_id)
            Image.fromarray(np.asarray(image).astype("uint8")).save(
                pathname)
            return FrameOutput(True, {"pathname": pathname})

    engine = EventEngine()
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name="video_to_images", engine=engine,
        transport_factory=lambda on_message, lt, lp, lr: MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lt,
            lwt_payload=lp, lwt_retain=lr)).initialize()

    graph = "(PE_VideoReadFile (PE_ImageAnnotate (PE_NumberedWrite)))" \
        if args.overlay else "(PE_VideoReadFile (PE_NumberedWrite))"
    elements = [
        {"name": "PE_VideoReadFile", "input": [],
         "output": [{"name": "image"}]},
        {"name": "PE_NumberedWrite", "input": [{"name": "image"}],
         "output": [{"name": "pathname"}]},
    ]
    if args.overlay:
        elements.insert(1, {"name": "PE_ImageAnnotate",
                            "input": [{"name": "image"}],
                            "output": [{"name": "image"}]})
    pipeline = Pipeline(
        runtime,
        parse_pipeline_definition({
            "version": 0, "name": "p_v2i", "runtime": "python",
            "graph": [graph],
            "parameters": {"PE_VideoReadFile.pathname": args.video,
                           "PE_VideoReadFile.rate": args.rate},
            "elements": elements,
        }),
        element_classes={"PE_NumberedWrite": PE_NumberedWrite},
        stream_lease_time=0)

    written = []
    pipeline.add_frame_handler(lambda frame: written.append(frame))
    pipeline.create_stream("v", lease_time=0)
    # PE_VideoReadFile stops creating frames at EOF; run until quiet
    last = -1
    while True:
        engine.run_until(lambda: False, timeout=1.0)
        if len(written) == last:
            break
        last = len(written)
    pipeline.destroy_stream("v")
    runtime.terminate()
    print(f"wrote {len(written)} images to {args.image_pattern}")
    return 0 if written else 1


if __name__ == "__main__":
    raise SystemExit(main())
