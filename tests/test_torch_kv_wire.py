"""The port's KV transfer, batch and migrate envelopes against the JAX
package's (aiko_services_tpu/transport/wire.py): for equal inputs and
explicit ids both packages encode the same bytes, each decodes the
other's envelopes to the same values (bf16 bits, int8 planes and scales
exactly), and a truncated, drifted or wrong-dtype envelope raises
WireError in both, before any row could reach a cache.  The cases are
tests/test_disagg.py's TestKVTransferWire and its wire-level review
fixes, run on both packages."""

import ml_dtypes
import numpy as np
import pytest
import torch

from aiko_services_tpu.transport import wire as JW
from aiko_services_tpu_torch.transport import wire as TW

LAYOUT = ("2", "2", "16", "bfloat16", "True", "8", "2")
PACKAGES = {"jax": JW, "torch": TW}


def int8_blocks(seed=3, count=2, layers=2):
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(count):
        per_layer = []
        for _ in range(layers):
            per_layer.append({
                side: {"q": rng.integers(-127, 127, (2, 8, 16),
                                         dtype=np.int8),
                       "s": rng.random((2, 8), np.float32)}
                for side in ("k", "v")})
        blocks.append(per_layer)
    return blocks


def bf16_rows(seed=5, shape=(2, 8, 4)):
    """(the JAX form, the port's form) of one bf16 rows array with the
    same bits: an ml_dtypes array and a torch tensor."""
    values = np.random.default_rng(seed).standard_normal(shape)
    rows = values.astype(np.float32).astype(ml_dtypes.bfloat16)
    tensor = torch.from_numpy(rows.view(np.int16).copy()).view(
        torch.bfloat16)
    return rows, tensor


def bits(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16).numpy()
    return np.asarray(leaf).view(np.int16)


@pytest.mark.parametrize("sender,receiver", [
    ("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_int8_layout_roundtrip_bit_exact(sender, receiver):
    blocks = int8_blocks()
    payload = PACKAGES[sender].encode_kv_transfer(
        "t1", "team.a", list(range(20)), 1, 8, LAYOUT, blocks,
        first_token=42)
    out = PACKAGES[receiver].decode_kv_transfer(payload)
    assert (out["transfer_id"], out["tenant"], out["start_block"],
            out["block_tokens"], out["first_token"], out["layout"],
            out["final"]) == ("t1", "team.a", 1, 8, 42, LAYOUT, True)
    np.testing.assert_array_equal(out["tokens"],
                                  np.arange(20, dtype=np.int32))
    for b in range(2):
        for layer in range(2):
            for side in ("k", "v"):
                sent = blocks[b][layer][side]
                got = out["blocks"][b][layer][side]
                np.testing.assert_array_equal(got["q"], sent["q"])
                np.testing.assert_array_equal(got["s"], sent["s"])


def test_int8_and_f32_envelopes_have_equal_bytes():
    blocks = int8_blocks()
    args = ("t1", "team.a", list(range(20)), 1, 8, LAYOUT, blocks)
    assert TW.encode_kv_transfer(*args, first_token=42) == \
        JW.encode_kv_transfer(*args, first_token=42)
    rows = np.random.default_rng(1).random((2, 8, 4), np.float32)
    f32 = [[{"k": rows, "v": rows * 2}]]
    for final in (True, False):
        assert TW.encode_kv_transfer("t", "", range(8), 0, 8, ("l",), f32,
                                     final=final) == \
            JW.encode_kv_transfer("t", "", range(8), 0, 8, ("l",), f32,
                                  final=final)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_native_bf16_roundtrip_bit_exact(receiver):
    rows, tensor = bf16_rows()
    port = TW.encode_kv_transfer("t2", "", list(range(8)), 0, 8, ("l",),
                                 [[{"k": tensor, "v": tensor}]])
    jax_payload = JW.encode_kv_transfer("t2", "", list(range(8)), 0, 8,
                                        ("l",), [[{"k": rows, "v": rows}]])
    assert port == jax_payload
    for payload in (port, jax_payload):
        out = PACKAGES[receiver].decode_kv_transfer(payload)
        got = out["blocks"][0][0]["k"]
        if receiver == "torch":
            assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(got), bits(rows))


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_truncation_raises_wire_error(receiver):
    rows = np.zeros((2, 8, 4), np.float32)
    for sender in PACKAGES.values():
        payload = sender.encode_kv_transfer("t3", "", list(range(8)), 0, 8,
                                            (), [[{"k": rows, "v": rows}]])
        for cut in (len(payload) // 3, len(payload) - 7):
            with pytest.raises(PACKAGES[receiver].WireError):
                PACKAGES[receiver].decode_kv_transfer(payload[:cut])


@pytest.mark.parametrize("bad", [
    np.zeros((2, 8, 4), np.float64), np.zeros((2, 8), np.float32),
    torch.zeros((2, 8, 4), dtype=torch.float64),
    {"q": np.zeros((2, 8, 4), np.int8), "s": np.zeros((2, 4), np.float32)},
    {"q": np.zeros((2, 8, 4), np.int16), "s": np.zeros((2, 8), np.float32)},
    {"q": np.zeros((2, 8, 4), np.int8)}])
def test_illegal_leaf_refused_at_encode(bad):
    good = np.zeros((2, 8, 4), np.float32)
    with pytest.raises(TW.WireError):
        TW.encode_kv_transfer("t", "", [1], 0, 8, (),
                              [[{"k": bad, "v": good}]])
    if not isinstance(bad, torch.Tensor):
        with pytest.raises(JW.WireError):
            JW.encode_kv_transfer("t", "", [1], 0, 8, (),
                                  [[{"k": bad, "v": good}]])


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_wrong_block_length_refused_at_decode(receiver):
    rows = np.zeros((2, 6, 4), np.float32)      # 6 != block 8
    for sender in PACKAGES.values():
        payload = sender.encode_kv_transfer("t", "", list(range(8)), 0, 8,
                                            (), [[{"k": rows, "v": rows}]])
        with pytest.raises(PACKAGES[receiver].WireError):
            PACKAGES[receiver].decode_kv_transfer(payload)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_foreign_command_refused(receiver):
    for sender in PACKAGES.values():
        payload = sender.encode_envelope("process_frame", ["s", {}])
        with pytest.raises(PACKAGES[receiver].WireError):
            PACKAGES[receiver].decode_kv_transfer(payload)
        with pytest.raises(PACKAGES[receiver].WireError):
            PACKAGES[receiver].decode_kv_batch(payload)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_non_array_leaves_raise_wire_error(receiver):
    """A drifted kv_transfer whose leaves decoded as strings fails as
    WireError (the recovery ladder's catch), never AttributeError."""
    tokens = np.arange(8, dtype=np.int32)
    for sender in PACKAGES.values():
        for params in (
                ["t", "", "0", "8", "", [], {"tokens": tokens},
                 [[{"k": "garbage", "v": "garbage"}]]],
                ["t", "", "0", "8", "", [], {"tokens": tokens},
                 [[{"k": {"q": "x", "s": "y"}, "v": "z"}]]],
                ["t", "", "0", "8", "", [], {"tokens": "nope"}, []],
                ["t", "", "x", "8", "", [], {"tokens": tokens}, []],
                ["t", "", "0", "0", "", [], {"tokens": tokens}, []],
                ["t", "", "0", "8", "", [], {"tokens": tokens}, [[]]],
                ["t", "", "0", "8"]):
            payload = sender.encode_envelope("kv_transfer", params)
            with pytest.raises(PACKAGES[receiver].WireError):
                PACKAGES[receiver].decode_kv_transfer(payload)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_chunk_flag_crosses(receiver):
    rows = np.ones((2, 8, 4), np.float32)
    for sender in PACKAGES.values():
        payload = sender.encode_kv_transfer(
            "c", "", list(range(16)), 1, 8, ("l",),
            [[{"k": rows, "v": rows}]], final=False)
        out = PACKAGES[receiver].decode_kv_transfer(payload)
        assert out["final"] is False and out["start_block"] == 1
        assert out["first_token"] is None


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_batch_members_fail_alone(receiver):
    """One truncated member of a batch envelope fails alone; its
    siblings decode, in both packages, and the batch bytes agree."""
    rows = np.zeros((2, 8, 16), np.float32)
    blocks = [[{"k": rows, "v": rows} for _ in range(2)]]
    good = TW.encode_kv_transfer("g1", "", list(range(16)), 0, 8,
                                 ("2", "2", "16", "float32", "False", "8",
                                  "4"), blocks)
    assert good == JW.encode_kv_transfer(
        "g1", "", list(range(16)), 0, 8,
        ("2", "2", "16", "float32", "False", "8", "4"), blocks)
    batch = TW.encode_kv_batch([good[:40], good])
    assert batch == JW.encode_kv_batch([good[:40], good])
    package = PACKAGES[receiver]
    members = package.decode_kv_batch(batch)
    assert len(members) == 2
    with pytest.raises(package.WireError):
        package.decode_kv_transfer(members[0])
    assert package.decode_kv_transfer(members[1])["transfer_id"] == "g1"
    with pytest.raises(package.WireError):
        package.decode_kv_batch(good)           # not a batch
    with pytest.raises(package.WireError):
        package.encode_kv_batch([])
    command, params = package.decode_envelope(
        TW.encode_envelope(TW.KV_BATCH_COMMAND, [["not bytes"]]))
    with pytest.raises(package.WireError):
        package.kv_batch_members(command, params)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_migrate_offer_and_replies_cross(receiver):
    trace = ["__aikt__", "tr1", "sp1", "", "0.5"]
    args = ("mig-1", "team", "s7", "ns/h/1/migrate", [3, 4, 5],
            [3, 4, 5, 6, 7])
    offer = TW.encode_kv_migrate(*args, trace=trace)
    assert offer == JW.encode_kv_migrate(*args, trace=trace)
    package = PACKAGES[receiver]
    out = package.validate_kv_migrate_params(
        *package.decode_envelope(offer))
    assert (out["transfer_id"], out["tenant"], out["sid"],
            out["reply_topic"]) == args[:4]
    np.testing.assert_array_equal(out["tokens"], [3, 4, 5])
    np.testing.assert_array_equal(out["history"], [3, 4, 5, 6, 7])
    for command in (TW.KV_MIGRATE_ACK_COMMAND, TW.KV_MIGRATE_DONE_COMMAND):
        reply = TW.encode_kv_migrate_reply(command, "mig-1", 5)
        assert reply == JW.encode_kv_migrate_reply(command, "mig-1", 5)
        assert package.validate_kv_migrate_reply(
            *package.decode_envelope(reply)) == ("mig-1", 5)


@pytest.mark.parametrize("receiver", ["jax", "torch"])
def test_malformed_migrate_envelopes_raise(receiver):
    package = PACKAGES[receiver]
    bad = [
        TW.encode_envelope("kv_migrate", ["m", "t", "s", "r",
                                          {"tokens": "x"}, {"history": []}]),
        TW.encode_envelope("kv_migrate", ["m", "t", "s"]),
        TW.encode_envelope("kv_migrate_ack", ["m"]),
        TW.encode_envelope("kv_migrate_ack", ["m", "x"]),
        TW.encode_envelope("kv_migrate_done", ["m", "-1"]),
    ]
    with pytest.raises(package.WireError):
        package.validate_kv_migrate_params(*package.decode_envelope(bad[0]))
    with pytest.raises(package.WireError):
        package.validate_kv_migrate_params(*package.decode_envelope(bad[1]))
    for payload in bad[2:]:
        with pytest.raises(package.WireError):
            package.validate_kv_migrate_reply(
                *package.decode_envelope(payload))
    with pytest.raises(package.WireError):
        package.encode_kv_migrate_reply("kv_transfer", "m", 1)
    with pytest.raises(package.WireError):
        package.encode_kv_migrate("m", "t", "s", "r", [[1]], [1])
    with pytest.raises(package.WireError):
        package.validate_kv_migrate_reply("kv_migrate", ["m", "1"])


def test_schema_tables_equal_jax():
    assert TW.KV_TRANSFER_SCHEMA == JW.KV_TRANSFER_SCHEMA
    assert TW.KV_TRANSFER_DTYPES == JW.KV_TRANSFER_DTYPES
    assert TW.KV_TRANSFER_RANK == JW.KV_TRANSFER_RANK
    assert TW.KV_TRANSFER_PARAMS == JW.KV_TRANSFER_PARAMS
    for field, dtype, ndim in (("kv", "bfloat16", 3), ("kv", "float64", 3),
                               ("kv_q", "int8", 3), ("kv_s", "float32", 1),
                               ("tokens", "int32", 1), ("nope", "int8", 1)):
        assert TW.kv_leaf_legal(field, dtype, ndim) == \
            JW.kv_leaf_legal(field, dtype, ndim)
    assert TW.kv_leaf_legal("kv", torch.bfloat16, 3)
