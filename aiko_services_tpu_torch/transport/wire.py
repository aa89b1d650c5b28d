# Binary wire envelope: the data-plane payload encoding.
#
# The port's own copy of aiko_services_tpu/transport/wire.py.  The control
# plane speaks S-expression text (utils/sexpr.py); tensors ride a
# length-prefixed binary envelope instead:
#
#   AIKW | version u8 | header_len u32 | header sexpr (utf-8)
#        | buffer_count u32 | (buffer_len u64, raw bytes) * count
#
# The header is an ordinary RPC S-expression "(command param...)" in which
# every array / bytes value has been replaced by a marker list
# ["__aikb__", index, kind, dtype, dims, codec, meta]; the raw bytes ride
# out-of-band after the header.  The bytes are the JAX package's for
# equal values: the two packages read each other's envelopes.
#
# Tensors: a numpy array encodes as in JAX.  A torch tensor encodes as
# the numpy array of its values; a tensor on the card takes ONE host copy
# here, at the edge, and nowhere else.  That copy waits for the work
# queued on the tensor's stream; `host_copies` counts the copies and the
# seconds they took.  bfloat16 ships as its raw 2-byte values under the
# dtype tag "bfloat16" and comes back as a torch.bfloat16 tensor (numpy
# has no bfloat16 without ml_dtypes, which the port does not use).
# Decoding hands out every other array as a read-only np.frombuffer VIEW
# over the received payload (small arrays in a large envelope are copied
# out, also read-only): an element that wraps one in a tensor copies
# first.
#
# Codec tags (opt-in, per dict key):
#   "mulaw" — µ-law companding: float audio ships as uint8 codes;
#   "i8"    — absmax int8 with one f32 scale in the tag;
#   "i8mel" — log-mel int8 with one scale PER MEL FRAME packed into the
#             buffer ([T, M+4] int8; ops/audio.py mel_i8_pack);
#   "dct8"  — blockwise DCT of uint8 images: int8 zigzag coefficients
#             (ops/image_wire.py), decoded on the host.
# A value the wire cannot carry, or a codec illegal for its dtype or
# rank, raises WireError.
#
# Everything that is not an array/bytes keeps S-expression semantics:
# scalars arrive as strings, exactly like the text path.  encode_rpc
# picks the text path for non-binary transports and for payloads
# without binary values.

from __future__ import annotations

import struct
import time

import numpy as np
import torch

from ..observe.tracing import TRACE_MARKER
from ..utils.sexpr import generate, generate_sexpr, parse_sexpr

__all__ = [
    "MAGIC", "WIRE_VERSION", "WireError", "is_envelope", "contains_binary",
    "encode_envelope", "decode_envelope", "read_envelope", "encode_rpc",
    "supports_binary", "WIRE_CODECS", "WIRE_CODEC_DTYPES",
    "WIRE_CODEC_RANK", "codec_legal", "pop_trace", "TENANT_MARKER",
    "tenant_fields", "is_tenant_fields", "parse_tenant", "pop_tenant",
    "BUFFER_MARKER", "BUFFER_MARKER_ARITY", "TRACE_FIELDS_ARITY",
    "TENANT_FIELDS_ARITY", "HOP_ENTRY_FIELDS", "HOP_ENTRY_OPTIONAL",
    "host_copies", "encode_kv_transfer", "decode_kv_transfer",
    "encode_kv_batch", "decode_kv_batch", "encode_kv_migrate",
    "encode_kv_migrate_reply",
]

MAGIC = b"AIKW"
WIRE_VERSION = 1
_MARKER = BUFFER_MARKER = "__aikb__"
# trace-context header marker: a trailing parameter
# ["__aikt__", trace_id, span_id, remaining, sent], stripped on decode
_TRACE = TRACE_MARKER
# tenant header marker: a trailing parameter ["__aikn__", tenant, tier]
# AFTER the trace marker, stripped on decode — the serving admission
# gate (ops/admission.py) charges the frame to its tenant's budget
TENANT_MARKER = "__aikn__"
BUFFER_MARKER_ARITY = 7    # [tag, index, kind, dtype, dims, codec, meta]
TRACE_FIELDS_ARITY = 5     # [tag, trace_id, span_id, remaining, sent]
TENANT_FIELDS_ARITY = 3    # [tag, tenant, tier]
# one pipeline request hop on the wire (pipeline.py _hop_entry builds
# it; process_frames_remote consumes it positionally)
HOP_ENTRY_FIELDS = ("stream_id", "inputs", "reply_topic", "hop_id")
HOP_ENTRY_OPTIONAL = ("trace", "tenant")
_HEAD = struct.Struct("<BI")            # version, header_len
_COUNT = struct.Struct("<I")
_BUFLEN = struct.Struct("<Q")

KV_ENVELOPES_NOT_PORTED = ("the KV transfer and migrate envelopes are not "
                           "ported yet: they need disaggregated serving "
                           "(ROADMAP.md Queue 1 item 3)")

# device-to-host copies made by the encoder (tensors on the card), and
# the wall seconds they took: each waits for the tensor's stream
host_copies = {"count": 0, "seconds": 0.0}


class WireError(ValueError):
    """Raised when a value cannot ride the wire, or a payload is not a
    well-formed binary envelope."""


def supports_binary(transport) -> bool:
    """True when `transport` can carry bytes payloads end to end
    (Message implementations declare it with a BINARY class attr)."""
    return bool(getattr(transport, "BINARY", False))


def is_envelope(payload) -> bool:
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return bytes(payload[:4]) == MAGIC
    return False


def contains_binary(obj) -> bool:
    """True when obj (recursively) holds an array, a tensor or bytes —
    the test for whether the sexpr text path could even express it."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return True
    if not isinstance(obj, (str, int, float, bool, type(None))) \
            and _is_arraylike(obj):
        return True
    if isinstance(obj, dict):
        return any(contains_binary(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(contains_binary(v) for v in obj)
    return False


def _is_arraylike(obj) -> bool:
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return True
    return hasattr(obj, "shape") and hasattr(obj, "dtype")


def _host_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor's values on the host: one copy for a tensor on the
    card (counted in host_copies), none for a host tensor."""
    tensor = tensor.detach()
    if tensor.device.type == "cpu":
        return tensor
    started = time.perf_counter()
    tensor = tensor.cpu()
    host_copies["count"] += 1
    host_copies["seconds"] += time.perf_counter() - started
    return tensor


def _host_array(obj, values: bool = False):
    """(numpy array, dtype name) for an array-like.  A bfloat16 tensor
    gives its raw 2-byte values as int16 under the name "bfloat16", or,
    with values=True (what a codec quantizes), its values as float32."""
    if isinstance(obj, torch.Tensor):
        tensor = _host_tensor(obj)
        if tensor.dtype == torch.bfloat16:
            if values:
                return tensor.float().numpy(), "bfloat16"
            return tensor.contiguous().view(torch.int16).numpy(), \
                "bfloat16"
        try:
            array = tensor.numpy()
        except TypeError as exc:
            raise WireError(f"the wire cannot carry a {tensor.dtype} "
                            f"tensor: {exc}") from exc
        return array, str(array.dtype)
    array = np.asarray(obj)
    if values and str(array.dtype) == "bfloat16":
        return array.astype(np.float32), "bfloat16"
    return array, str(array.dtype)


def _as_dtype(values: np.ndarray, dtype: str):
    """Cast decoded codec values to the tagged dtype (bfloat16: a torch
    tensor)."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(values, np.float32)).to(torch.bfloat16)
    return values.astype(dtype)


# -- codecs ------------------------------------------------------------------
# Each codec: encode(np.ndarray of values) -> (coded np.ndarray, meta);
#             decode(np.ndarray, meta) -> the value, up to the codec's
#             documented loss.  The tagged dtype is meta[0].

def _mulaw_encode(array):
    from ..ops.audio import mulaw_encode
    return mulaw_encode(array), [str(array.dtype)]


def _mulaw_decode(codes, meta):
    # numpy inverse of ops.audio.mulaw_decode (host-side: the transport
    # must not touch the card)
    from ..ops.audio import MULAW_MU
    x = codes.astype(np.float32) * (1.0 / 127.5) - 1.0
    audio = np.sign(x) * np.expm1(
        np.abs(x) * np.log1p(MULAW_MU)) * (1.0 / MULAW_MU)
    return _as_dtype(audio, meta[0] if meta else "float32")


def _i8_encode(array):
    # scale from FINITE values only: one inf/NaN glitch sample must not
    # poison the whole tensor (inf scale -> all-NaN decode); non-finite
    # entries saturate (inf) or zero (NaN) instead
    x = array.astype(np.float32)
    finite = x[np.isfinite(x)]
    scale = float(np.max(np.abs(finite))) / 127.0 if finite.size else 0.0
    scale = scale if scale and np.isfinite(scale) else 1.0
    bound = 127.0 * scale
    x = np.nan_to_num(x, nan=0.0, posinf=bound, neginf=-bound)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, [str(array.dtype), repr(scale)]


def _i8_decode(q, meta):
    dtype, scale = meta[0], float(meta[1])
    return _as_dtype(q.astype(np.float32) * scale, dtype)


def _i8mel_encode(array):
    # per-ROW absmax int8, one f32 scale per mel frame packed into the
    # trailing 4 bytes of each row (ops/audio.py mel_i8_pack)
    from ..ops.audio import mel_i8_pack
    return mel_i8_pack(array), [str(array.dtype)]


def _i8mel_decode(packed, meta):
    from ..ops.audio import mel_i8_unpack
    return _as_dtype(mel_i8_unpack(packed), meta[0] if meta else "float32")


def _dct8_encode(array):
    from ..ops.image_wire import dct8_encode
    h, w, _ = array.shape
    return dct8_encode(array), [str(array.dtype), str(h), str(w)]


def _dct8_decode(codes, meta):
    # numpy inverse of ops.image_wire.dct8_decode (host-side: the
    # transport must not touch the card)
    from ..ops.image_wire import _DCT, _QUANT, _ZIGZAG
    dtype, height, width = meta[0], int(meta[1]), int(meta[2])
    hb, wb, channels, keep = codes.shape
    flat = np.zeros((hb, wb, channels, 64), np.float32)
    flat[..., _ZIGZAG[:keep]] = codes.astype(np.float32)
    coeffs = flat.reshape(hb, wb, channels, 8, 8) * _QUANT
    blocks = np.einsum("ik,whckl,jl->whcij", _DCT.T, coeffs, _DCT.T,
                       optimize=True)
    image = (blocks + 128.0).transpose(0, 3, 1, 4, 2).reshape(
        height, width, channels)
    return np.clip(np.round(image), 0, 255).astype(dtype)


WIRE_CODECS = {
    "mulaw": (_mulaw_encode, _mulaw_decode),
    "i8": (_i8_encode, _i8_decode),
    "i8mel": (_i8mel_encode, _i8mel_decode),
    "dct8": (_dct8_encode, _dct8_decode),
}

# What each lossy codec can CARRY (the JAX package's table, so a hint
# legal in one package is legal in the other):
#   mulaw: companding of float audio in [-1, 1];
#   i8, i8mel: absmax quantization of float tensors;
#   dct8:  blockwise DCT of uint8 images, shape [H, W, C].
WIRE_CODEC_DTYPES = {
    "mulaw": ("float16", "float32", "float64"),
    "i8": ("float16", "float32", "float64", "bfloat16"),
    "i8mel": ("float16", "float32", "float64", "bfloat16"),
    "dct8": ("uint8",),
}
WIRE_CODEC_RANK = {"dct8": 3, "i8mel": 2}


def codec_legal(codec: str, dtype, ndim: int | None = None) -> bool:
    """True when `codec` can legally carry an array of `dtype` (and,
    when given, rank `ndim`)."""
    allowed = WIRE_CODEC_DTYPES.get(codec)
    if allowed is None or str(dtype) not in allowed:
        return False
    rank = WIRE_CODEC_RANK.get(codec)
    return ndim is None or rank is None or ndim == rank


# -- encode ------------------------------------------------------------------

def _extract(obj, buffers, key=None, codec_hints=None):
    """Walk obj, replacing array/bytes values with marker lists and
    appending their raw bytes (as memoryviews — no copy until the final
    join) to `buffers`."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        index = len(buffers)
        buffers.append(memoryview(obj).cast("B"))
        return [_MARKER, str(index), "bytes", "", [], "", []]
    if _is_arraylike(obj) and not isinstance(obj, (str, int, float, bool)):
        codec = (codec_hints or {}).get(key, "")
        meta: list = []
        if codec:
            if codec not in WIRE_CODECS:
                raise WireError(f"unknown wire codec {codec!r}")
            array, dtype = _host_array(obj, values=True)
            if not codec_legal(codec, dtype, array.ndim):
                raise WireError(
                    f"wire codec {codec!r} cannot carry key {key!r} "
                    f"(dtype {dtype}, rank {array.ndim}; legal "
                    f"dtypes: {WIRE_CODEC_DTYPES[codec]})")
            array, meta = WIRE_CODECS[codec][0](array)
            meta[0] = dtype
            dtype = str(array.dtype)
        else:
            array, dtype = _host_array(obj)
        if not array.flags.c_contiguous:
            array = np.ascontiguousarray(array)
        index = len(buffers)
        try:
            buffers.append(memoryview(array).cast("B"))
        except (ValueError, TypeError):
            # extension dtypes lack the buffer protocol: reinterpret
            # the same memory as uint8
            buffers.append(memoryview(
                array.reshape(-1).view(np.uint8)).cast("B"))
        return [_MARKER, str(index), "nd", dtype,
                [str(d) for d in array.shape], codec, meta]
    if isinstance(obj, dict):
        return {k: _extract(v, buffers, key=k, codec_hints=codec_hints)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_extract(v, buffers, key=key, codec_hints=codec_hints)
                for v in obj]
    return obj


def pop_trace(parameters):
    """Strip a trailing trace-context marker from a decoded parameter
    list; returns the marker's field list or None."""
    if isinstance(parameters, list) and parameters:
        last = parameters[-1]
        if isinstance(last, (list, tuple)) and last and \
                isinstance(last[0], str) and last[0] == _TRACE:
            return list(parameters.pop())
    return None


def tenant_fields(tenant, tier=1) -> list:
    """The wire form of a tenant tag: a self-tagged field list, so it
    can ride as a trailing header parameter OR as a positional hop-entry
    field without ambiguity against trace fields."""
    return [TENANT_MARKER, str(tenant), str(int(tier))]


def is_tenant_fields(value) -> bool:
    return isinstance(value, (list, tuple)) and bool(value) and \
        isinstance(value[0], str) and value[0] == TENANT_MARKER


def parse_tenant(fields, default_tier: int = 1):
    """(tenant, tier) from a tenant field list; ("", default_tier) when
    absent/malformed — the admission gate folds "" into its default
    tenant bucket."""
    if not is_tenant_fields(fields) or len(fields) < 2:
        return "", int(default_tier)
    tenant = str(fields[1])
    try:
        tier = int(fields[2]) if len(fields) > 2 else int(default_tier)
    except (TypeError, ValueError):
        tier = int(default_tier)
    return tenant, tier


def pop_tenant(parameters):
    """Strip a trailing tenant marker from a decoded parameter list;
    returns the field list or None.  Runs BEFORE pop_trace: the tenant
    marker is appended after the trace marker on encode."""
    if isinstance(parameters, list) and parameters:
        if is_tenant_fields(parameters[-1]):
            return list(parameters.pop())
    return None


def encode_envelope(command: str, parameters=(), codec_hints=None,
                    trace=None, tenant=None) -> bytes:
    """RPC (command, params) -> one binary envelope payload.

    codec_hints: {dict_key: codec_name} — arrays stored under a hinted
    dict key ship through that codec (lossy, opt-in).
    trace: an optional trace-context field list carried in the header.
    tenant: an optional tenant field list (tenant_fields) carried after
    the trace."""
    buffers: list[memoryview] = []
    extracted = [_extract(p, buffers, codec_hints=codec_hints)
                 for p in parameters]
    if trace:
        extracted.append([str(f) for f in trace])
    if tenant:
        extracted.append([str(f) for f in tenant])
    header = generate(command, extracted).encode("utf-8")
    parts = [MAGIC, _HEAD.pack(WIRE_VERSION, len(header)), header,
             _COUNT.pack(len(buffers))]
    for view in buffers:
        parts.append(_BUFLEN.pack(view.nbytes))
        parts.append(view)
    return b"".join(parts)


# -- decode ------------------------------------------------------------------

def _frombuffer(view, dtype: str, shape: tuple):
    if dtype == "bfloat16":
        # no numpy bfloat16 without ml_dtypes: the raw 2-byte values
        # become a torch.bfloat16 tensor (a copy, so it is writable)
        raw = np.frombuffer(view, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    try:
        np_dtype = np.dtype(dtype)
    except TypeError as exc:
        raise WireError(f"the port has no dtype {dtype!r}") from exc
    return np.frombuffer(view, dtype=np_dtype).reshape(shape)


def _restore(obj, buffers, payload_nbytes=0):
    if isinstance(obj, list) and len(obj) == BUFFER_MARKER_ARITY \
            and obj[0] == _MARKER:
        _, index, kind, dtype, dims, codec, meta = obj
        try:
            view = buffers[int(index)]
        except (IndexError, ValueError) as exc:
            raise WireError(f"envelope buffer {index!r} missing") from exc
        if kind == "bytes":
            return bytes(view)
        if isinstance(meta, dict):            # sexpr read 2-item meta back
            meta = [k2 for pair in meta.items() for k2 in pair]
        try:
            shape = tuple(int(d) for d in dims)
            array = _frombuffer(view, str(dtype), shape)
        except WireError:
            raise
        except Exception as exc:
            raise WireError(
                f"envelope buffer {index} does not match its "
                f"dtype/shape tag ({dtype}, {dims}): {exc}") from exc
        if codec:
            if codec not in WIRE_CODECS:
                raise WireError(f"unknown wire codec {codec!r}")
            return WIRE_CODECS[codec][1](array, list(meta))
        if isinstance(array, np.ndarray) and \
                array.nbytes * 8 < payload_nbytes:
            # a view pins the WHOLE envelope payload alive: a small
            # array in a large coalesced envelope is copied out instead
            array = array.copy()
            array.flags.writeable = False     # same contract as views
        return array                          # read-only zero-copy view
    if isinstance(obj, dict):
        return {k: _restore(v, buffers, payload_nbytes)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore(v, buffers, payload_nbytes) for v in obj]
    return obj


def read_envelope(payload):
    """One binary envelope payload -> (header expression, buffers): the
    parsed header with its buffer markers in place, and each buffer as a
    memoryview over `payload` — the bytes as they crossed, before any
    codec decodes them."""
    view = memoryview(payload).cast("B")
    if view.nbytes < 4 + _HEAD.size or bytes(view[:4]) != MAGIC:
        raise WireError("not a binary envelope (bad magic / truncated)")
    version, header_len = _HEAD.unpack_from(view, 4)
    if version != WIRE_VERSION:
        raise WireError(f"unsupported envelope version {version}")
    offset = 4 + _HEAD.size
    if offset + header_len + _COUNT.size > view.nbytes:
        raise WireError("envelope header overruns payload")
    try:
        header = bytes(view[offset:offset + header_len]).decode("utf-8")
    except UnicodeDecodeError as exc:
        raise WireError(f"envelope header is not utf-8: {exc}") from exc
    offset += header_len
    (count,) = _COUNT.unpack_from(view, offset)
    offset += _COUNT.size
    buffers = []
    for _ in range(count):
        if offset + _BUFLEN.size > view.nbytes:
            raise WireError("envelope buffer table overruns payload")
        (length,) = _BUFLEN.unpack_from(view, offset)
        offset += _BUFLEN.size
        if offset + length > view.nbytes:
            raise WireError("envelope buffer overruns payload")
        buffers.append(view[offset:offset + length])
        offset += length
    try:
        expr = parse_sexpr(header)
    except Exception as exc:
        raise WireError(f"envelope header parse failed: {exc}") from exc
    if not isinstance(expr, str) and (
            not isinstance(expr, list) or not expr or
            not isinstance(expr[0], str)):
        raise WireError(f"envelope header is not an RPC: {header!r}")
    return expr, buffers


def decode_envelope(payload, with_trace: bool = False,
                    with_tenant: bool = False):
    """One binary envelope payload -> (command, params), or
    (command, params, trace_fields|None) when with_trace=True, or
    (command, params, trace, tenant_fields|None) when with_tenant=True.

    Arrays come back as read-only views over `payload` (bfloat16 as a
    torch tensor); everything else keeps S-expression semantics
    (strings).  Trace and tenant headers are always stripped from the
    params, whether or not the caller asks for them back."""
    expr, buffers = read_envelope(payload)
    if isinstance(expr, str):
        if with_tenant:
            return expr, [], None, None
        return (expr, [], None) if with_trace else (expr, [])
    nbytes = memoryview(payload).nbytes
    params = [_restore(p, buffers, nbytes) for p in expr[1:]]
    tenant = pop_tenant(params)         # appended last; strip first
    trace = pop_trace(params)
    if with_tenant:
        return expr[0], params, trace, tenant
    if with_trace:
        return expr[0], params, trace
    return expr[0], params


# -- KV transfer / migrate envelopes (disaggregated serving) -----------------

def encode_kv_transfer(*_args, **_kwargs):
    raise NotImplementedError(KV_ENVELOPES_NOT_PORTED)


decode_kv_transfer = encode_kv_batch = decode_kv_batch = \
    encode_kv_migrate = encode_kv_migrate_reply = encode_kv_transfer


# -- the RPC entry -----------------------------------------------------------

def _text_value(value):
    """An array-like as nested lists of its values (the text path)."""
    if isinstance(value, torch.Tensor):
        return _host_tensor(value).tolist()
    return np.asarray(value).tolist()


def encode_rpc(command: str, parameters=(), transport=None,
               codec_hints=None, trace=None, tenant=None):
    """Pick the wire representation for an outbound RPC: the binary
    envelope when the transport can carry bytes AND the params hold
    binary values; S-expression text otherwise.  Trace and tenant field
    lists ride the envelope header on the binary path and as trailing
    marker parameters on the text path — decoders strip them either
    way (pop_trace / pop_tenant)."""
    if supports_binary(transport) and contains_binary(parameters):
        return encode_envelope(command, parameters,
                               codec_hints=codec_hints, trace=trace,
                               tenant=tenant)
    text_params = [
        p if not _is_arraylike(p) or isinstance(p, (str, int, float, bool))
        else generate_sexpr(_text_value(p)) for p in parameters]
    if trace:
        text_params.append([str(f) for f in trace])
    if tenant:
        text_params.append([str(f) for f in tenant])
    return generate(command, text_params)
