"""The binary wire (transport/wire.py) with tensors on the card: a tensor
on the card encodes to the same envelope bytes as its host copy, with
one device-to-host copy per tensor, counted.  Every test here needs an
NVIDIA card and skips without one.  On the card, from the repo root:
    python -m pytest --noconftest -m cuda tests/test_torch_wire_cuda.py -q
(nothing here imports jax)."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.elements.common import PE_DataEncode
from aiko_services_tpu_torch.transport import wire

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (tensors on the card)")
    return torch.device("cuda")


def _encode(value, hints=None):
    return wire.encode_envelope("f", [{"x": value, "n": 3}],
                                codec_hints=hints)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.uint8])
def test_a_card_tensor_crosses_as_its_host_copy(card, dtype):
    host = torch.arange(24, dtype=torch.float32).reshape(4, 6).to(dtype)
    on_card = host.to(card)[:, 1:5]            # a strided view
    wire.host_copies.update(count=0, seconds=0.0)
    payload = _encode(on_card)
    assert wire.host_copies["count"] == 1
    assert payload == _encode(host[:, 1:5].contiguous())
    _, (decoded,) = wire.decode_envelope(payload)
    back = decoded["x"]
    if dtype == torch.bfloat16:
        assert back.dtype == torch.bfloat16 and back.device.type == "cpu"
    else:
        back = torch.from_numpy(np.array(back))
    assert torch.equal(back, host[:, 1:5])


@pytest.mark.parametrize("codec,shape,dtype", [
    ("i8mel", (300, 80), torch.float32),
    ("i8", (50, 80), torch.bfloat16),
    ("mulaw", (16000,), torch.float32)])
def test_codecs_on_card_tensors_give_the_host_bytes(card, codec, shape,
                                                    dtype):
    generator = torch.Generator().manual_seed(0)
    host = (0.5 * torch.randn(shape, generator=generator)).clamp(-1, 1) \
        .to(dtype)
    wire.host_copies.update(count=0, seconds=0.0)
    payload = _encode(host.to(card), {"x": codec})
    assert wire.host_copies["count"] == 1
    assert payload == _encode(host, {"x": codec})


def test_data_encode_takes_one_host_copy_of_a_card_tensor(card):
    host = torch.linspace(-1, 1, 12).reshape(3, 4)
    element = PE_DataEncode.__new__(PE_DataEncode)
    on_card = element.process_frame(None, data=host.to(card))
    assert on_card.outputs == element.process_frame(None,
                                                    data=host).outputs


def test_a_card_tensors_envelope_crosses_a_tcp_peer_channel(card):
    """Two runtimes on TCP peer channels (127.0.0.1): the envelope of a
    card tensor, encoded with its one host copy, crosses the socket byte
    for byte and decodes to the tensor's values."""
    import time

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    engine, broker = EventEngine(), MemoryBroker()
    runtimes = [ProcessRuntime(
        name=name, engine=engine,
        transport_factory=lambda on_message, *_: MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
        for name in ("tx", "rx")]
    sender, receiver = runtimes
    try:
        sender.enable_peer(kinds=("tcp",))
        receiver.enable_peer(kinds=("tcp",))
        topic = f"{receiver.topic_path}/1/in"
        got = []
        receiver.add_message_handler(lambda t, p: got.append(bytes(p)),
                                     topic)
        sender.peer.negotiate(f"{receiver.topic_path}/1",
                              receiver.peer.tag.split("=", 1)[1],
                              pin_topics=[topic], reply_topics=[])
        assert engine.run_until(lambda: sender.peer.pinned(topic),
                                timeout=10.0)
        values = torch.arange(300 * 80, dtype=torch.float32).reshape(300, 80)
        wire.host_copies.update(count=0, seconds=0.0)
        payload = _encode(values.to(card))
        assert wire.host_copies["count"] == 1
        started = time.monotonic()
        sender.publish(topic, payload)
        assert engine.run_until(lambda: got, timeout=10.0), \
            time.monotonic() - started
        assert got == [payload]
        assert [c.kind for c in sender.peer._channels.values()] == ["tcp"]
        _, (decoded,) = wire.decode_envelope(got[0])
        assert torch.equal(torch.from_numpy(np.array(decoded["x"])), values)
    finally:
        for runtime in runtimes:
            runtime.terminate()
