"""The package re-exports and the moved names the port gained to match
the JAX package's surface, each reached by its package path and held
against the JAX name at the same path on the CPU:

  - `ops`: AdmissionGate, TenantFairQueue, TenantPolicy, BatchItem,
    BatchingScheduler, ShapeBuckets — a seeded script of submits and
    drains through the package names gives the same dispatches and
    depths on both packages, and the same bucket for every length;
  - `transport`: the wire's WIRE_CODECS, WireError, encode_envelope,
    decode_envelope, encode_rpc, is_envelope, contains_binary,
    supports_binary — the same envelope bytes for seeded numpy arrays,
    each side decoding the other's, and the same refusals;
  - `elements.speech`: load_flat_npz / save_flat_npz, the bridge's one
    implementation, reading and writing JAX's flat-npz files: the
    values each side reads from either side's file are equal (f32,
    exact)."""

import functools

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.ops as JOps
import aiko_services_tpu.transport as JTransport
import aiko_services_tpu_torch.ops as TOps
import aiko_services_tpu_torch.transport as TTransport
from aiko_services_tpu.elements import speech as JSpeech
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.elements import speech as TSpeech
from aiko_services_tpu_torch.models import whisper as TW

torch.set_num_threads(1)

OPS_NAMES = ["AdmissionGate", "BatchItem", "BatchingScheduler",
             "ShapeBuckets", "TenantFairQueue", "TenantPolicy"]
WIRE_NAMES = ["WIRE_CODECS", "WireError", "contains_binary",
              "decode_envelope", "encode_envelope", "encode_rpc",
              "is_envelope", "supports_binary"]


def test_ops_reexports_the_admission_and_batching_names():
    from aiko_services_tpu_torch.ops import admission, batching
    assert sorted(TOps.__all__) == sorted(JOps.__all__) == OPS_NAMES
    for name in OPS_NAMES:
        module = admission if hasattr(admission, name) else batching
        assert getattr(TOps, name) is getattr(module, name), name


def _fair_queue_script(ops, seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    queue = ops.TenantFairQueue(
        policies={"gold": ops.TenantPolicy(weight=2.0, tier=0),
                  "bulk": ops.TenantPolicy(weight=1.0, queue_budget=3)},
        base_budget=4, global_budget=9, clock=lambda: now[0])
    log = []
    for step in range(60):
        now[0] += float(rng.uniform(0.0, 0.05))
        if rng.random() < 0.8:
            tenant = str(rng.choice(["gold", "bulk", "free"]))
            log.append(("submit", queue.submit(
                tenant, f"{tenant}{step}",
                shed=lambda item: log.append(("shed", item)),
                tier=int(rng.integers(0, 3))), queue.depth()))
        else:
            dispatched = []
            queue.drain(dispatched.append, limit=int(rng.integers(1, 4)))
            log.append(("drain", dispatched))
    buckets = ops.ShapeBuckets([64, 16, 256])
    log.append([buckets.bucket_for(int(n))
                for n in rng.integers(1, 257, size=32)])
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        buckets.bucket_for(257)
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_ops_package_names_run_the_jax_script(seed):
    port = _fair_queue_script(TOps, seed)
    assert port == _fair_queue_script(JOps, seed)
    assert any(entry[0] == "shed" for entry in port[:-1])


def test_transport_reexports_the_wire_names():
    from aiko_services_tpu_torch.transport import wire
    for name in WIRE_NAMES:
        assert getattr(TTransport, name) is getattr(wire, name), name
    assert set(TTransport.WIRE_CODECS) == set(JTransport.WIRE_CODECS)
    assert issubclass(TTransport.WireError, ValueError)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transport_envelopes_are_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal((3, 5)).astype(np.float32),
              {"ids": rng.integers(0, 1000, size=7).astype(np.int32),
               "name": f"s{seed}"}, int(rng.integers(100))]
    payload = TTransport.encode_envelope("frame", params)
    assert payload == JTransport.encode_envelope("frame", params)
    assert TTransport.is_envelope(payload) and \
        JTransport.is_envelope(payload)
    assert TTransport.contains_binary(params) == \
        JTransport.contains_binary(params) is True
    for decode in (TTransport.decode_envelope, JTransport.decode_envelope):
        command, back = decode(payload)
        assert command == "frame"
        np.testing.assert_array_equal(np.asarray(back[0]), params[0])
        np.testing.assert_array_equal(np.asarray(back[1]["ids"]),
                                      params[1]["ids"])
        # text semantics: scalars come back as their text, on both sides
        assert back[1]["name"] == params[1]["name"]
        assert back[2] == str(params[2])

    class Binary:
        BINARY = True

    for transport in (Binary(), None):
        assert TTransport.supports_binary(transport) == \
            JTransport.supports_binary(transport)
        assert TTransport.encode_rpc("c", params, transport=transport) == \
            JTransport.encode_rpc("c", params, transport=transport)


def test_transport_refuses_what_jax_refuses():
    bad = b"not an envelope"
    assert not TTransport.is_envelope(bad) and not JTransport.is_envelope(bad)
    payload = JTransport.encode_envelope("c", [np.zeros(16, np.float32)])
    for decode, error in ((TTransport.decode_envelope, TTransport.WireError),
                          (JTransport.decode_envelope, JTransport.WireError)):
        with pytest.raises(error):
            decode(payload[:-8])


@functools.lru_cache(maxsize=None)
def _jax_whisper():
    config = JW.WHISPER_PRESETS["test"]
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(2))
    return config, jax.tree.map(np.asarray, params)


def test_speech_flat_npz_is_the_bridges_one_implementation():
    assert TSpeech.load_flat_npz is bridge.load_flat_npz
    assert TSpeech.save_flat_npz is bridge.save_flat_npz
    assert {"load_flat_npz", "save_flat_npz"} <= set(TSpeech.__all__)


def test_speech_flat_npz_reads_and_writes_jax_files(tmp_path):
    config, params = _jax_whisper()
    jax_file = str(tmp_path / "jax.npz")
    JSpeech.save_flat_npz(params, jax_file)
    t_config = TW.WHISPER_PRESETS["test"]
    model = TW.whisper_init(torch.Generator().manual_seed(9), t_config,
                            device="cpu")
    assert TSpeech.load_flat_npz(model, jax_file) is model
    want = bridge.flatten_tree(params)
    got = {name.replace(".", "/"): p.detach().numpy()
           for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    port_file = str(tmp_path / "port.npz")
    TSpeech.save_flat_npz(model, port_file)
    fresh = jax.tree.map(np.zeros_like, params)
    back = bridge.flatten_tree(jax.tree.map(
        np.asarray, JSpeech.load_flat_npz(fresh, port_file)))
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
