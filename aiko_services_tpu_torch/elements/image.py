# Image elements: file I/O, transforms, annotation, and batched
# classification on the ComputeRuntime.
#
# Counterpart of aiko_services_tpu/elements/image.py: PE_ImageReadFile,
# PE_ImageWriteFile, PE_ImageResize, PE_ImageAnnotate and PE_ImageOverlay
# are host code on PIL (imported inside the calls that need it), and
# PE_ImageClassify (BASELINE.md config 2, "ResNet-18 image-classify
# PipelineElement") batches frames through a ComputeRuntime program that
# runs ResNet, softmax, argmax and max on the device: the host gets back
# one [B] int and one [B] float per batch.

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import DEFERRED, Frame, FrameOutput, PipelineElement
from .speech import _host_to

__all__ = [
    "PE_ImageReadFile", "PE_ImageWriteFile", "PE_ImageResize",
    "PE_ImageAnnotate", "PE_ImageOverlay", "PE_ImageClassify",
]


def resize_image(image, width: int, height: int) -> np.ndarray:
    """uint8 RGB [H, W, 3] → [height, width, 3] (PIL's default filter)."""
    from PIL import Image
    return np.asarray(Image.fromarray(np.asarray(image).astype("uint8"))
                      .resize((int(width), int(height))))


class PE_ImageReadFile(PipelineElement):
    """pathname (parameter or swag) → image [H, W, 3] uint8."""

    contracts = {"out:image": "u8[*,*,3]"}

    def process_frame(self, frame: Frame, pathname=None, **_) -> FrameOutput:
        from PIL import Image

        if pathname is None:
            pathname, found = self.get_parameter("pathname",
                                                 stream=frame.stream)
            if not found:
                return FrameOutput(False, diagnostic="no pathname")
        image = Image.open(str(pathname)).convert("RGB")
        return FrameOutput(True, {"image": np.asarray(image)})


class PE_ImageWriteFile(PipelineElement):
    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        from PIL import Image

        pathname, found = self.get_parameter("pathname",
                                             stream=frame.stream)
        if not found:
            return FrameOutput(False, diagnostic="no pathname")
        pathname = str(pathname).format(stream_id=frame.stream_id,
                                        frame_id=frame.frame_id)
        Image.fromarray(np.asarray(image).astype("uint8")).save(pathname)
        return FrameOutput(True, {})


class PE_ImageResize(PipelineElement):

    contracts = {"in:image": "u8[*,*,3] | f32[*,*,3]",
                 "out:image": "u8[*,*,3]"}

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        width, _ = self.get_parameter("width", 224, frame.stream)
        height, _ = self.get_parameter("height", 224, frame.stream)
        return FrameOutput(True, {"image": resize_image(image, width,
                                                        height)})


class PE_ImageAnnotate(PipelineElement):
    """Draws text + optional boxes onto the image."""

    def process_frame(self, frame: Frame, image=None, text="",
                      boxes=None, **_) -> FrameOutput:
        from PIL import Image, ImageDraw

        pil = Image.fromarray(np.asarray(image).astype("uint8"))
        draw = ImageDraw.Draw(pil)
        if text:
            draw.text((8, 8), str(text), fill=(255, 32, 32))
        for box in boxes or []:
            draw.rectangle([tuple(box[:2]), tuple(box[2:4])],
                           outline=(32, 255, 32), width=2)
        return FrameOutput(True, {"image": np.asarray(pil)})


class PE_ImageOverlay(PipelineElement):
    """Alpha-blend `overlay` onto `image`."""

    def process_frame(self, frame: Frame, image=None, overlay=None,
                      **_) -> FrameOutput:
        alpha, _ = self.get_parameter("alpha", 0.5, frame.stream)
        image = np.asarray(image, dtype="float32")
        overlay = np.asarray(overlay, dtype="float32")
        if overlay.shape != image.shape:
            overlay = resize_image(overlay, image.shape[1],
                                   image.shape[0]).astype("float32")
        blended = (1 - float(alpha)) * image + float(alpha) * overlay
        return FrameOutput(True,
                           {"image": blended.clip(0, 255).astype("uint8")})


def collate_images(payloads, rows: int, size: int,
                   device: torch.device) -> torch.Tensor:
    """Frames [size, size, 3] → one [rows, size, size, 3] batch on
    `device` in one copy: uint8 when every frame is uint8 (a quarter of
    f32's bytes), else float32 values; zero rows pad past the frames.
    The program divides by 255 on the device."""
    arrays = [np.asarray(p) for p in payloads]
    dtype = np.uint8 if all(a.dtype == np.uint8 for a in arrays) \
        else np.float32
    batch = np.zeros((rows, size, size, 3), dtype)
    for i, array in enumerate(arrays):
        batch[i] = array
    return _host_to(device, batch)


class PE_ImageClassify(PipelineElement):
    """Batched ResNet classification through the ComputeRuntime.  Emits
    {"class_id", "confidence"}.

    Parameters: preset (resnet18 / resnet34), image_size, mode
    ("batched" | "sync"), max_batch, max_wait, compute (service name).
    Weights are random, drawn from a torch.Generator seeded 0 on the
    ComputeRuntime's device."""

    # any-size RGB frame (resized host-side); outputs are python
    # scalars (int class id, float confidence)
    contracts = {
        "in:image": "u8[*,*,3] | f32[*,*,3]",
        "out:class_id": "any", "out:confidence": "any",
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._program = f"classify.{self.definition.name}"
        self._setup_done = False

    def _setup(self) -> None:
        if self._setup_done:
            return
        from ..models.resnet import (RESNET_PRESETS, local_classes,
                                     resnet_axes, resnet_forward,
                                     resnet_init)
        from ..parallel.collectives import (axis_spans, greedy_pick,
                                            shifted_logsumexp)

        preset, _ = self.get_parameter("preset", "resnet18")
        image_size, _ = self.get_parameter("image_size", 224)
        max_batch, _ = self.get_parameter("max_batch", 32)
        max_wait, _ = self.get_parameter("max_wait", 0.05)
        self.mode, _ = self.get_parameter("mode", "batched")
        self.image_size = int(image_size)

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.runtime.service_by_name(compute_name)
        if self.compute is None:
            raise RuntimeError(
                f"classify element {self.name}: no ComputeRuntime "
                f"service named {compute_name!r}")
        device = self.compute.device
        self.config = config = RESNET_PRESETS[str(preset)]
        # on a model axis the head is cut by its classes (resnet_axes),
        # which must divide; the backbone stays whole on every rank
        mesh = self.compute.sharding_mesh
        local_classes(config, mesh)
        params = resnet_init(torch.Generator(device=device).manual_seed(0),
                             config, device=device)
        self.params = self.compute.place_params(params, resnet_axes(params))
        sharded = axis_spans(mesh, "model")

        @torch.no_grad()
        def run_bucket(_bucket, images):
            logits = resnet_forward(self.params, config,
                                    images.float() / 255.0, mesh)
            if sharded:
                # JAX's argmax and max of the softmax over every rank's
                # chunk: the first maximal class, and exp(max - logsumexp)
                _, shifted = shifted_logsumexp(logits, "model", mesh=mesh)
                return greedy_pick(logits, "model", mesh=mesh), \
                    torch.exp(-shifted)
            probs = torch.softmax(logits, dim=-1)
            return probs.argmax(dim=-1), probs.max(dim=-1).values

        def collate(_bucket, payloads):
            return collate_images(payloads, len(payloads), self.image_size,
                                  device)

        def split(results, count):
            class_ids, confidences = (r.cpu().numpy() for r in results)
            return [(int(class_ids[i]), float(confidences[i]))
                    for i in range(count)]

        self.compute.register_batched(
            self._program, run_bucket, [self.image_size], collate, split,
            max_batch=int(max_batch), max_wait=float(max_wait))
        self._setup_done = True

    def start_stream(self, stream) -> None:
        self._setup()

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        self._setup()
        image = np.asarray(image)
        if image.shape[0] != self.image_size or \
                image.shape[1] != self.image_size:
            image = resize_image(image, self.image_size, self.image_size)

        if self.mode == "sync":
            box = {}
            self.compute.submit(self._program, frame.stream_id, image,
                                self.image_size,
                                lambda _sid, r: box.setdefault("r", r))
            self.compute.programs[self._program].scheduler.drain(
                force=True)
            result = box["r"]
            if isinstance(result, Exception):
                return FrameOutput(False, diagnostic=repr(result))
            class_id, confidence = result
            return FrameOutput(True, {"class_id": class_id,
                                      "confidence": confidence})

        def callback(_sid, result):
            outputs = result if isinstance(result, Exception) else \
                {"class_id": result[0], "confidence": result[1]}
            self.pipeline.post("resume_frame", frame,
                               self.definition.name, outputs)

        self.compute.submit(self._program, frame.stream_id, image,
                            self.image_size, callback)
        return FrameOutput(True, DEFERRED)
