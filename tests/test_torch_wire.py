"""The port's binary wire (transport/wire.py) held against the JAX
package's: the same inputs give the same envelope bytes (numpy arrays of
every dtype and shape tests/test_transport.py ships, bfloat16 included,
and CPU torch tensors of the same values), each package decodes the
other's envelopes, the codecs are byte-equal (non-finite inputs
included), malformed envelopes raise WireError, and what waits for later
items raises NotImplementedError naming it.  Also the memory broker's
data plane and the process runtime's binary topics, call for call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import audio as JAudio
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu.transport import wire as JW
from aiko_services_tpu_torch.ops import audio as TAudio
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.transport import wire as TW


def _arrays():
    return [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.arange(6, dtype=np.int32),
        np.arange(8, dtype=np.uint8).reshape(2, 2, 2),
        np.array(2.5, dtype=np.float64),              # 0-d
        np.zeros((0,), dtype=np.int16),               # empty
        np.array([True, False]),
        np.arange(10, dtype=np.int64)[::2],           # not contiguous
        np.linspace(-1, 1, 7).astype(np.float16),
        np.asarray(jnp.linspace(-2, 2, 16, dtype=jnp.bfloat16)),
    ]


def _tensor(array):
    """A CPU torch tensor of the same values (bfloat16 through f32)."""
    if str(array.dtype) == "bfloat16":
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(array.copy())         # C order, any rank


PARAMETERS = [
    ("s1", {"n": 7, "ok": True, "x": 2.5, "none": None}, b"\x00\xffraw"),
    ("nested", {"a": [1, "two", {"b": "c"}]}),
]


@pytest.mark.parametrize("index", range(len(_arrays())))
def test_array_envelopes_are_jax_bytes(index):
    array = _arrays()[index]
    params = ["f", {"value": array, "tag": "t"}, [array, 3]]
    reference = JW.encode_envelope("c", params)
    assert TW.encode_envelope("c", params) == reference
    tensor = _tensor(array)
    assert TW.encode_envelope(
        "c", ["f", {"value": tensor, "tag": "t"}, [tensor, 3]]) == reference
    assert TW.host_copies["count"] == 0       # host tensors: no copy


@pytest.mark.parametrize("params", PARAMETERS)
def test_scalar_envelopes_and_text_rpcs_are_jax_bytes(params):
    assert TW.encode_envelope("c", params) == \
        JW.encode_envelope("c", params)

    class Binary:
        BINARY = True

    class TextOnly:
        BINARY = False

    array = np.arange(4, dtype=np.float32)
    for transport in (Binary(), TextOnly(), None):
        for rpc in (list(params), [array, "x"], ["x", {"a": 1}]):
            assert TW.encode_rpc("c", rpc, transport=transport) == \
                JW.encode_rpc("c", rpc, transport=transport)
    # a tensor on the text path: nested lists of its values, as JAX
    assert TW.encode_rpc("c", [torch.arange(4.0)], transport=TextOnly()) \
        == JW.encode_rpc("c", [array], transport=TextOnly())


def test_trace_and_tenant_headers_are_jax_bytes_and_stripped():
    trace = ["__aikt__", "t1", "s1", "0.5", "12.0"]
    tenant = JW.tenant_fields("acme", 0)
    assert TW.tenant_fields("acme", 0) == tenant
    params = [np.arange(3, dtype=np.int32), "x"]
    reference = JW.encode_envelope("c", params, trace=trace, tenant=tenant)
    payload = TW.encode_envelope("c", params, trace=trace, tenant=tenant)
    assert payload == reference
    command, decoded, got_trace, got_tenant = TW.decode_envelope(
        payload, with_tenant=True)
    assert (command, got_trace, got_tenant) == ("c", trace, tenant)
    assert len(decoded) == 2 and decoded[1] == "x"
    assert TW.parse_tenant(got_tenant) == JW.parse_tenant(got_tenant) \
        == ("acme", 0)
    assert TW.parse_tenant(None) == ("", 1)
    # the text path carries the same markers and strips them alike
    text = TW.encode_rpc("c", ["x"], trace=trace, tenant=tenant)
    assert text == JW.encode_rpc("c", ["x"], trace=trace, tenant=tenant)


def test_each_package_decodes_the_others_envelopes():
    for array in _arrays():
        params = [{"value": array}, b"raw", "s"]
        for encode, decode in ((JW.encode_envelope, TW.decode_envelope),
                               (TW.encode_envelope, JW.decode_envelope)):
            command, (value, raw, text) = decode(encode("c", params))
            assert (command, raw, text) == ("c", b"raw", "s")
            restored = value["value"]
            if isinstance(restored, torch.Tensor):
                # the port restores bfloat16 as a torch tensor
                assert restored.dtype == torch.bfloat16
                restored = restored.float().numpy()
            else:
                assert str(restored.dtype) == str(array.dtype)
            assert restored.shape == array.shape
            np.testing.assert_array_equal(
                np.asarray(restored, np.float64),
                np.asarray(array, np.float64))


def test_decode_views_are_read_only_and_small_arrays_copied_out():
    big = np.arange(1000, dtype=np.float32)
    _, (restored,) = TW.decode_envelope(TW.encode_envelope("f", [big]))
    assert not restored.flags.writeable and not restored.flags.owndata
    small = np.arange(3, dtype=np.int32)
    _, (tokens, _) = TW.decode_envelope(
        TW.encode_envelope("f", [small, big]))
    # a small array in a large envelope does not pin the payload
    assert tokens.flags.owndata and not tokens.flags.writeable
    # bfloat16: a writable torch tensor (a copy), no ml_dtypes needed
    values = torch.linspace(-3, 3, 9).to(torch.bfloat16)
    _, (back,) = TW.decode_envelope(TW.encode_envelope("f", [values]))
    assert back.dtype == torch.bfloat16 and torch.equal(back, values)


CODEC_INPUTS = {
    "mulaw": lambda rng: (0.3 * np.sin(np.linspace(0, 100, 800))
                          ).astype(np.float32),
    "i8": lambda rng: rng.standard_normal((50, 80)).astype(np.float32),
    "i8mel": lambda rng: (rng.standard_normal((50, 80)) * np.linspace(
        0.01, 4.0, 50)[:, None]).astype(np.float32),
}


@pytest.mark.parametrize("codec", sorted(CODEC_INPUTS))
@pytest.mark.parametrize("nonfinite", [False, True])
def test_codecs_are_jax_bytes(codec, nonfinite):
    value = CODEC_INPUTS[codec](np.random.default_rng(0))
    if nonfinite:
        flat = value.reshape(-1)
        flat[3], flat[7], flat[11] = np.inf, np.nan, -np.inf
    hints = {"value": codec}
    reference = JW.encode_envelope("f", [{"value": value}],
                                   codec_hints=hints)
    assert TW.encode_envelope("f", [{"value": value}],
                              codec_hints=hints) == reference
    assert TW.encode_envelope("f", [{"value": torch.from_numpy(value)}],
                              codec_hints=hints) == reference
    _, (port,) = TW.decode_envelope(reference)
    _, (jax,) = JW.decode_envelope(reference)
    assert port["value"].dtype == np.float32
    np.testing.assert_array_equal(port["value"], jax["value"])


def test_i8_codec_carries_bfloat16_as_jax_does():
    values = np.asarray(jnp.linspace(-2, 2, 32, dtype=jnp.bfloat16))
    reference = JW.encode_envelope("f", [{"x": values}],
                                   codec_hints={"x": "i8"})
    assert TW.encode_envelope("f", [{"x": values}],
                              codec_hints={"x": "i8"}) == reference
    assert TW.encode_envelope("f", [{"x": _tensor(values)}],
                              codec_hints={"x": "i8"}) == reference
    _, (port,) = TW.decode_envelope(reference)
    _, (jax,) = JW.decode_envelope(reference)
    assert port["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["x"].float().numpy(),
                                  np.asarray(jax["x"], np.float32))


def test_mel_codec_functions_are_jax_bytes():
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((40, 80)).astype(np.float32)
    mel[2, 3], mel[5, 6] = np.inf, np.nan
    for port, jax in ((TAudio.mel_i8_pack, JAudio.mel_i8_pack),
                      (TAudio.mulaw_encode, JAudio.mulaw_encode)):
        assert port(mel).tobytes() == jax(mel).tobytes()
    codes, scales = TAudio.mel_i8_encode(mel)
    ref_codes, ref_scales = JAudio.mel_i8_encode(mel)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(scales, ref_scales)
    np.testing.assert_array_equal(TAudio.mel_i8_decode(codes, scales),
                                  JAudio.mel_i8_decode(codes, scales))
    packed = TAudio.mel_i8_pack(mel)
    np.testing.assert_array_equal(TAudio.mel_i8_unpack(packed),
                                  JAudio.mel_i8_unpack(packed))
    empty = np.zeros((0, 80), np.float32)
    assert TAudio.mel_i8_unpack(TAudio.mel_i8_pack(empty)).shape == (0, 80)
    with pytest.raises(ValueError):
        TAudio.mel_i8_encode(np.zeros((8,), np.float32))


@pytest.mark.parametrize("case", [
    "magic", "truncated", "version", "header_overrun", "buffer_missing",
    "dtype_shape", "unknown_codec_tag", "not_rpc"])
def test_malformed_envelopes_raise_wire_error(case):
    good = JW.encode_envelope("f", [np.arange(10)])
    payload = {
        "magic": b"nope",
        "truncated": good[:-9],
        "version": good[:4] + b"\x09" + good[5:],
        "header_overrun": good[:5] + (10 ** 6).to_bytes(4, "little")
        + good[9:],
        "buffer_missing": None,
        "dtype_shape": good.replace(b"(10)", b"(11)"),
        "unknown_codec_tag": JW.encode_envelope(
            "f", [{"m": np.zeros((2, 80), np.float32)}],
            codec_hints={"m": "i8"}).replace(b" i8 ", b" zz "),
        "not_rpc": None,
    }[case]
    if payload is None:
        # by hand: a header that is a list, not an RPC, or a marker
        # that points past the buffer table
        import struct
        header = b"((a b))" if case == "not_rpc" else \
            b'(f (__aikb__ 3 nd int64 (10) "" ()))'
        payload = b"AIKW" + struct.pack("<BI", 1, len(header)) + header + \
            struct.pack("<I", 0)
    with pytest.raises(TW.WireError):
        TW.decode_envelope(payload)
    with pytest.raises(JW.WireError):
        JW.decode_envelope(payload)


def test_unencodable_values_raise_wire_error_as_jax_does():
    mel = np.zeros((8,), np.float32)
    for module in (TW, JW):
        with pytest.raises(module.WireError, match="i8mel"):
            module.encode_envelope("f", [{"mel": mel}],
                                   codec_hints={"mel": "i8mel"})
        with pytest.raises(module.WireError, match="unknown wire codec"):
            module.encode_envelope("f", [{"mel": mel}],
                                   codec_hints={"mel": "zip"})
        with pytest.raises(module.WireError, match="mulaw"):
            module.encode_envelope(
                "f", [{"a": np.arange(4, dtype=np.int32)}],
                codec_hints={"a": "mulaw"})
    # the port: a bfloat16 tensor under mulaw, and a dtype numpy lacks
    with pytest.raises(TW.WireError, match="mulaw"):
        TW.encode_envelope("f", [{"a": torch.zeros(4, dtype=torch.bfloat16)}],
                           codec_hints={"a": "mulaw"})
    with pytest.raises(TW.WireError):
        TW.encode_envelope(
            "f", [torch.zeros(4, dtype=torch.float8_e4m3fn)])


def test_later_items_raise_not_implemented_naming_them():
    image = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8\\)"):
        TW.encode_envelope("f", [{"image": image}],
                           codec_hints={"image": "dct8"})
    dct8 = JW.encode_envelope("f", [{"image": image}],
                              codec_hints={"image": "dct8"})
    with pytest.raises(NotImplementedError, match="Queue 1 item 8\\)"):
        TW.decode_envelope(dct8)
    for entry in (TW.encode_kv_transfer, TW.decode_kv_transfer,
                  TW.encode_kv_batch, TW.decode_kv_batch,
                  TW.encode_kv_migrate, TW.encode_kv_migrate_reply):
        with pytest.raises(NotImplementedError,
                           match="Queue 1 item 6\\)"):
            entry("x")
    assert TW.codec_legal("dct8", "uint8", 3) == \
        JW.codec_legal("dct8", "uint8", 3)
    assert TW.WIRE_CODEC_DTYPES == JW.WIRE_CODEC_DTYPES
    assert TW.WIRE_CODEC_RANK == JW.WIRE_CODEC_RANK


def test_contains_binary_and_is_envelope_agree_with_jax():
    cases = ["s", 3, None, b"x", [1, {"a": np.zeros(2)}],
             {"a": [1, 2]}, np.float32(1.0), (1, "x")]
    for case in cases:
        assert TW.contains_binary(case) == JW.contains_binary(case)
        assert TW.is_envelope(case) == JW.is_envelope(case)
    assert TW.contains_binary({"t": torch.zeros(2)})
    assert TW.is_envelope(TW.encode_envelope("c", []))


# ---------------------------------------------------------------------------
# The memory broker's data plane
# ---------------------------------------------------------------------------

def _data_plane_run(memory, policy):
    broker = memory.MemoryBroker(data_queue_limit=3)
    broker.mark_data_plane("data/#")
    seen = []
    consumer = memory.MemoryMessage(
        on_message=lambda t, p: seen.append((t, p)),
        subscriptions=["data/#", "ctl"], broker=broker, drop_policy=policy)
    consumer.connect()
    sender = memory.MemoryMessage(broker=broker)
    sender.connect()
    consumer.hold()
    for i in range(6):
        sender.publish("data/x", f"d{i}")
        sender.publish("ctl", f"c{i}")
    consumer.release()
    return seen, dict(consumer.stats), dict(broker.stats)


@pytest.mark.parametrize("policy", ["oldest", "newest"])
def test_bounded_data_queues_shed_as_jax_does(policy):
    port = _data_plane_run(TM, policy)
    assert port == _data_plane_run(JM, policy)
    seen, client_stats, _ = port
    # control-plane messages are never shed; data keeps 3 of 6
    assert [p for t, p in seen if t == "ctl"] == [f"c{i}" for i in range(6)]
    assert len([p for t, p in seen if t == "data/x"]) == 3
    assert client_stats["dropped"] == 3


def test_binary_topics_pass_bytes_through_undecoded():
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    broker = TM.MemoryBroker()
    runtime = ProcessRuntime(
        name="host", engine=EventEngine(VirtualClock()),
        transport_factory=lambda on_message, *_: TM.MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    seen = []
    runtime.add_message_handler(lambda t, p: seen.append(p), "raw/bin",
                                binary=True)
    runtime.add_message_handler(lambda t, p: seen.append(p), "raw/text")
    envelope = TW.encode_envelope("f", [np.arange(3)])
    runtime.publish("raw/bin", b"\xff\x00")
    runtime.publish("raw/text", b"hello")
    runtime.publish("raw/text", envelope)
    while runtime.event.step():
        pass
    # bytes on a binary topic and envelopes anywhere stay bytes; other
    # bytes payloads decode to text
    assert seen == [b"\xff\x00", "hello", envelope]
    assert broker._is_data_topic("raw/bin")
    # the peer data plane is there: enable_peer is idempotent
    host = runtime.enable_peer()
    assert runtime.enable_peer() is host and host.tag.startswith("peer=")
    runtime.terminate()
    assert host.closed


def test_elements_copy_read_only_wire_views_before_wrapping_them():
    """A wire view is read-only: PE_LogMel wraps the audio it is given
    in a tensor only after copying it (no warning, no write through)."""
    import warnings

    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)
    from aiko_services_tpu_torch.process import ProcessRuntime
    audio = (0.1 * np.sin(np.arange(16000) / 50.0)).astype(np.float32)
    _, (decoded,) = TW.decode_envelope(
        TW.encode_envelope("f", [{"audio": audio}]))
    assert not decoded["audio"].flags.writeable
    runtime = ProcessRuntime(
        name="mel", engine=EventEngine(VirtualClock()),
        transport_factory=lambda on_message, *_: TM.MemoryMessage(
            on_message=on_message, broker=TM.MemoryBroker())).initialize()
    pipeline = Pipeline(runtime, parse_pipeline_definition({
        "version": 0, "name": "p_mel", "runtime": "python",
        "graph": ["(PE_LogMel)"],
        "parameters": {"PE_LogMel.device": "cpu"},
        "elements": [{"name": "PE_LogMel", "input": [{"name": "audio"}],
                      "output": [{"name": "mel"}]}]}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        result = pipeline.process_frame("*", decoded)
    assert result.ok and tuple(result.outputs["mel"].shape) == (100, 80)
