"""Assemble numbered images into a video file through the port's
pipeline: the port's copy of examples/pipeline/images_to_video.py
(reference parity: examples/pipeline/images_to_video.py —
ImageReadFile → VideoWriteFile on the 2020 pipeline).

PE_ImageReadFile declares the posted `pathname` as its input, so the
walk hands it each frame's file; the JAX script declares none, its
element finds no pathname and every frame fails (ROADMAP Queue 3 item
18).  The run ends once every posted frame has completed or failed.

Usage:
    python -m aiko_services_tpu_torch.examples.pipeline.images_to_video \
        "in/image_{frame:06d}.jpg" output.mp4 [--fps 29.97]
"""

# an example script: its console lines are its output
# graft: disable-file=lint-print

import argparse
import glob
import re
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("image_pattern",
                        help='e.g. "in/image_{frame:06d}.jpg"')
    parser.add_argument("video")
    parser.add_argument("--fps", type=float, default=29.97)
    args = parser.parse_args(argv)

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.pipeline import Pipeline, \
        parse_pipeline_definition
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport.memory import (MemoryBroker,
                                                          MemoryMessage)

    # expand the numbered pattern to the existing, sorted input files
    wildcard = re.sub(r"\{frame[^}]*\}", "*", args.image_pattern)
    pathnames = sorted(glob.glob(wildcard))
    if not pathnames:
        print(f"no images match {wildcard}", file=sys.stderr)
        return 1

    engine = EventEngine()
    broker = MemoryBroker()
    runtime = ProcessRuntime(
        name="images_to_video", engine=engine,
        transport_factory=lambda on_message, lt, lp, lr: MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lt,
            lwt_payload=lp, lwt_retain=lr)).initialize()

    pipeline = Pipeline(
        runtime,
        parse_pipeline_definition({
            "version": 0, "name": "p_i2v", "runtime": "python",
            "graph": ["(PE_ImageReadFile (PE_VideoWriteFile))"],
            "parameters": {"PE_VideoWriteFile.pathname": args.video,
                           "PE_VideoWriteFile.rate": args.fps},
            "elements": [
                {"name": "PE_ImageReadFile",
                 "input": [{"name": "pathname"}],
                 "output": [{"name": "image"}]},
                {"name": "PE_VideoWriteFile",
                 "input": [{"name": "image"}], "output": []},
            ],
        }),
        stream_lease_time=0)

    done = []
    pipeline.add_frame_handler(done.append)
    pipeline.create_stream("v", lease_time=0)
    for pathname in pathnames:
        pipeline.post("process_frame", "v", {"pathname": pathname})
    engine.run_until(
        lambda: len(done) + pipeline.recovery_stats["frames_failed"] >=
        len(pathnames), timeout=600.0)
    pipeline.destroy_stream("v")          # flushes/releases the writer
    runtime.terminate()
    print(f"wrote {len(done)} frames to {args.video}")
    return 0 if len(done) == len(pathnames) else 1


if __name__ == "__main__":
    raise SystemExit(main())
