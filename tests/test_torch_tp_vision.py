"""PE_ImageClassify and PE_Detect on a model axis, against the JAX
package's models placed by the same axes on a virtual mesh.

Each gloo rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`tp_vision`) runs each element in a one-element pipeline on a
ComputeRuntime over {model: 2} and {model: 4}, batched, at 64 x 64, the
JAX trees' weights placed through the runtime by their axes.  ResNet-18
(1000 classes) places by resnet_axes: "channels" maps to no mesh axis,
so the backbone stays whole and only the head is cut, each rank holding
its chunk of the classes; the class is the first maximal logit over
every rank's chunk (collectives.greedy_pick) and the confidence exp(max
- logsumexp) (shifted_logsumexp), JAX's argmax and max of the softmax.
The detector places by detector_axes, which cut nothing: it stays the
whole module on every rank, as JAX replicates it.  The JAX reference
places the same trees by the same axes over {model: n} of the virtual
CPU devices.

Tolerances, f32: class ids equal; confidences within 1e-6 absolute
(XLA's and torch's convolutions sum in other orders, and the softmax's
maximum and exp(max - logsumexp) round differently: measured up to
4.5e-7 at confidences of 0.06-0.2); detections as tests/test_torch_vision_pipeline.py holds
them: classes equal, scores within 1e-4, boxes within 1e-3 + 1e-4
relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import detector as JDet
from aiko_services_tpu.models import resnet as JR

import torch_spmd_cases as cases
from torch_spmd import run_ranks

RESNET = JR.RESNET_PRESETS["resnet18"]
DETECTOR = JDet.DETECTOR_PRESETS["detector_test"]
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4}}
SIZE = 64
# colour ramps, which random ResNet-18 weights put in classes of
# different ranks' chunks (seeded noise all lands in one class), and a
# black frame, whose logits all tie: the first class wins, on rank 0
CLASSIFY_FRAMES = [np.repeat((np.linspace(0, 255, SIZE)[None, :, None] *
                              np.asarray(colour)[None, None, :]), SIZE,
                             axis=0).astype(np.uint8)
                   for colour in ([1, 0, 0], [0, 1, 0], [0, 0, 1],
                                  [1, 1, 0], [0, 1, 1], [1, 0, 1])] + \
    [np.zeros((SIZE, SIZE, 3), np.uint8)]
_rng = np.random.default_rng(11)
DETECT_FRAMES = [_rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
                 for _ in range(4)]
CONFIDENCE_TOL = 1e-6


@functools.cache
def trees():
    resnet = jax.jit(functools.partial(JR.resnet_init, config=RESNET))(
        jax.random.PRNGKey(1))
    detector = jax.jit(functools.partial(JDet.detector_init,
                                         config=DETECTOR))(
        jax.random.PRNGKey(2))
    return resnet, detector


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    resnet, detector = trees()
    out = {}
    for world, geometry in ((2, "model2"), (4, "model4")):
        results = run_ranks(
            cases.tp_vision, world,
            tmp_path_factory.mktemp(f"vision{world}"),
            {geometry: GEOMETRIES[geometry]}, _flat(resnet),
            _flat(detector), CLASSIFY_FRAMES, DETECT_FRAMES, SIZE,
            timeout=240.0)
        for key in results[0]:
            out[key] = [rank[key] for rank in results]
    return out


@functools.cache
def reference(n: int):
    """JAX's classes, confidences and detections with the trees placed
    by their axes over {model: n} of the virtual devices."""
    mesh = JP.create_mesh({"model": n}, devices=jax.devices()[:n])
    resnet, detector = trees()
    resnet = JP.shard_pytree(resnet, JR.resnet_axes(resnet), mesh)
    assert not resnet["head"]["w"].sharding.is_fully_replicated
    assert resnet["stem"].sharding.is_fully_replicated
    detector = JP.shard_pytree(detector, JDet.detector_axes(detector),
                               mesh)
    images = jnp.asarray(np.stack(CLASSIFY_FRAMES), jnp.float32) / 255.0
    logits = jax.jit(functools.partial(JR.resnet_forward, config=RESNET))(
        resnet, images=images)
    probs = jax.nn.softmax(logits, axis=-1)
    boxes, scores, classes = (np.asarray(x) for x in jax.jit(
        functools.partial(JDet.detect, config=DETECTOR,
                          score_threshold=0.0))(
        detector, images=jnp.asarray(np.stack(DETECT_FRAMES),
                                     jnp.float32) / 255.0))
    detections = []
    for i in range(len(DETECT_FRAMES)):
        keep = scores[i] > 0.0
        detections.append({"boxes": boxes[i][keep], "scores": scores[i][keep],
                           "classes": classes[i][keep].tolist()})
    return {"class_id": np.asarray(jnp.argmax(probs, axis=-1)).tolist(),
            "confidence": np.asarray(jnp.max(probs, axis=-1)),
            "detections": detections}


def _size(geometry) -> int:
    return GEOMETRIES[geometry]["model"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_classify_on_a_model_axis_gives_jax_s_classes(ranks, geometry):
    want = reference(_size(geometry))
    assert len({class_id * _size(geometry) // 1000
                for class_id in want["class_id"]}) > 1     # chunks
    for rank in ranks[(geometry, "classify")]:
        assert rank["class_id"] == want["class_id"]
        np.testing.assert_allclose(rank["confidence"], want["confidence"],
                                   rtol=0, atol=CONFIDENCE_TOL)


@pytest.mark.parametrize("geometry,n", [("model2", 2), ("model4", 4)])
def test_a_rank_holds_its_chunk_of_the_classes(ranks, geometry, n):
    for rank in ranks[(geometry, "classify")]:
        assert rank["head_w"] == (512, 1000 // n)
        assert rank["head_b"] == (1000 // n,)
        assert rank["stem"] == (7, 7, 3, 64)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_detector_stays_whole_and_detects_as_jax(ranks, geometry):
    want = reference(_size(geometry))["detections"]
    assert sum(len(frame["classes"]) for frame in want) > 0
    for rank in ranks[(geometry, "detect")]:
        assert rank["module"]
        for got, expected in zip(rank["detections"], want):
            assert got["classes"] == expected["classes"]
            np.testing.assert_allclose(got["scores"], expected["scores"],
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(
                np.asarray(got["boxes"]).reshape(-1, 4),
                expected["boxes"].reshape(-1, 4), rtol=1e-4, atol=1e-3)


def test_classes_that_do_not_divide_raise():
    from aiko_services_tpu_torch.models import resnet as TR

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, dim=None):
            return 3

    with pytest.raises(ValueError, match="num_classes 1000 does not divide"):
        TR.local_classes(TR.RESNET_PRESETS["resnet18"], Mesh())
