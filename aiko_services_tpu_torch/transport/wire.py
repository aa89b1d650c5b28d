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
    "host_copies", "KV_TRANSFER_PARAMS", "KV_TRANSFER_COMMAND",
    "KV_TRANSFER_SCHEMA", "KV_TRANSFER_DTYPES", "KV_TRANSFER_RANK",
    "kv_leaf_legal", "encode_kv_transfer", "decode_kv_transfer",
    "validate_kv_transfer_params", "KV_BATCH_COMMAND", "encode_kv_batch",
    "decode_kv_batch", "kv_batch_members", "KV_MIGRATE_COMMAND",
    "KV_MIGRATE_ACK_COMMAND", "KV_MIGRATE_DONE_COMMAND",
    "encode_kv_migrate", "validate_kv_migrate_params",
    "encode_kv_migrate_reply", "validate_kv_migrate_reply",
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

KV_TRANSFER_PARAMS = 8     # required param count; optional 9th "chunk"

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
# A prefill runtime ships computed prompt KV to a decode runtime as an
# ordinary binary envelope whose command is KV_TRANSFER_COMMAND: it rides
# peer channels, the broker fallback, chaos seams and tracing like every
# other data-plane envelope, but its tensor fields are declared here and
# checked on both ends, so a malformed transfer fails loudly instead of
# scattering garbage rows into a live KV cache.
#
# Wire layout (envelope params):
#   [transfer_id, tenant, start_block, block_tokens, first_token,
#    [layout fields...], {"tokens": i32[*]},
#    [ per-block [ per-layer {"k": leaf, "v": leaf} ] ]]
# where a leaf is a native rows array ([H, B, D], the decoder's compute
# dtype; bfloat16 as a torch tensor) or the int8 serving form
# {"q": i8[H, B, D], "s": f32[H, B]} (layers.quantize_kv_cache), carried
# bit-exact: the decode side installs the very bytes the donor stored.
# An optional ninth param "chunk" marks a non-final member of a
# chunk-streamed transfer.

KV_TRANSFER_COMMAND = "kv_transfer"
KV_TRANSFER_SCHEMA = {
    "tokens": "i32[*]",
    "kv": "bf16[*,*,*] | f32[*,*,*] | f16[*,*,*]",
    "kv_q": "i8[*,*,*]",
    "kv_s": "f32[*,*]",
}
# the enforcement twin of the schema above
KV_TRANSFER_DTYPES = {
    "tokens": ("int32",),
    "kv": ("bfloat16", "float32", "float16"),
    "kv_q": ("int8",),
    "kv_s": ("float32",),
}
KV_TRANSFER_RANK = {"tokens": 1, "kv": 3, "kv_q": 3, "kv_s": 2}


def _dtype_name(dtype) -> str:
    """A numpy or torch dtype as the wire names it ("bfloat16", ...)."""
    return str(dtype).replace("torch.", "")


def kv_leaf_legal(field: str, dtype, ndim: int) -> bool:
    """True when `field` may legally carry an array of `dtype` / rank
    (the KV-transfer analogue of codec_legal)."""
    allowed = KV_TRANSFER_DTYPES.get(field)
    return allowed is not None and _dtype_name(dtype) in allowed and \
        ndim == KV_TRANSFER_RANK[field]


def _is_nd_value(value) -> bool:
    return hasattr(value, "dtype") and hasattr(value, "ndim") and \
        hasattr(value, "shape")


def _check_kv_leaf(leaf, what: str):
    """Validate one K or V rows leaf against the declared schema and
    return it unchanged: encode fails before bytes move, decode before
    rows could reach a cache.  A leaf that decoded as something other
    than an array (a corrupt or drifted payload) is a WireError too."""
    if isinstance(leaf, dict):
        if set(leaf) != {"q", "s"}:
            raise WireError(
                f"kv_transfer {what}: int8 leaf must be {{'q','s'}}, "
                f"got keys {sorted(leaf)}")
        q, s = leaf["q"], leaf["s"]
        if not _is_nd_value(q) or not _is_nd_value(s):
            raise WireError(
                f"kv_transfer {what}: q/s must be arrays, got "
                f"{type(q).__name__}/{type(s).__name__}")
        if not kv_leaf_legal("kv_q", q.dtype, q.ndim):
            raise WireError(
                f"kv_transfer {what}: q must be "
                f"{KV_TRANSFER_SCHEMA['kv_q']}, got "
                f"{_dtype_name(q.dtype)} rank {q.ndim}")
        if not kv_leaf_legal("kv_s", s.dtype, s.ndim):
            raise WireError(
                f"kv_transfer {what}: s must be "
                f"{KV_TRANSFER_SCHEMA['kv_s']}, got "
                f"{_dtype_name(s.dtype)} rank {s.ndim}")
        if tuple(q.shape[:2]) != tuple(s.shape):
            raise WireError(
                f"kv_transfer {what}: scale shape {tuple(s.shape)} does "
                f"not match values {tuple(q.shape)}")
        return leaf
    if not _is_nd_value(leaf) or \
            not kv_leaf_legal("kv", leaf.dtype, leaf.ndim):
        dtype = getattr(leaf, "dtype", None)
        got = type(leaf).__name__ if dtype is None else _dtype_name(dtype)
        raise WireError(
            f"kv_transfer {what}: rows must be "
            f"{KV_TRANSFER_SCHEMA['kv']}, got {got} "
            f"rank {getattr(leaf, 'ndim', '?')}")
    return leaf


def encode_kv_transfer(transfer_id: str, tenant: str, tokens,
                       start_block: int, block_tokens: int,
                       layout, blocks, first_token: int | None = None,
                       trace=None, final: bool = True) -> bytes:
    """One KV-transfer envelope: `blocks` is [per block [per layer
    {"k": leaf, "v": leaf}]] covering chain blocks [start_block,
    start_block + len(blocks)) of `tokens`.  Blocks below start_block
    are handles: the receiver holds them already (its chain keys are
    content-addressed from the tokens), so only the index crosses.
    `layout` is the donor's storage-layout tuple (wire_layout), which
    the receiver matches before any row lands.  `final=False` marks a
    non-final chunk-stream member (the ninth "chunk" param)."""
    block_tokens = int(block_tokens)
    payload_blocks = []
    for b, per_layer in enumerate(blocks):
        layers = []
        for i, entry in enumerate(per_layer):
            what = f"block {b} layer {i}"
            layers.append({
                "k": _check_kv_leaf(entry["k"], what + " k"),
                "v": _check_kv_leaf(entry["v"], what + " v")})
        payload_blocks.append(layers)
    tokens = np.asarray(tokens, np.int32)
    if tokens.ndim != 1:
        raise WireError(
            f"kv_transfer tokens must be rank 1, got {tokens.ndim}")
    params = [str(transfer_id), str(tenant), str(int(start_block)),
              str(block_tokens),
              "" if first_token is None else str(int(first_token)),
              [str(f) for f in layout], {"tokens": tokens},
              payload_blocks]
    if not final:
        params.append("chunk")
    return encode_envelope(KV_TRANSFER_COMMAND, params, trace=trace)


# same-destination transfers coalesced into one envelope: the params are
# the members' complete encoded payloads as bytes fields, each decoded
# and checked on its own, so a truncated member fails alone
KV_BATCH_COMMAND = "kv_transfer_batch"


def encode_kv_batch(payloads, trace=None) -> bytes:
    """Coalesce encoded KV-transfer payloads into one batch envelope."""
    members = [bytes(p) for p in payloads]
    if not members:
        raise WireError("kv_transfer_batch with no members")
    return encode_envelope(KV_BATCH_COMMAND, [members], trace=trace)


def decode_kv_batch(payload) -> list:
    """The member payloads (bytes) of a batch envelope: decode each with
    decode_kv_transfer.  Raises WireError on a foreign command or
    members that are not bytes."""
    command, params = decode_envelope(payload)
    return kv_batch_members(command, params)


def kv_batch_members(command, params) -> list:
    """Validate an already-decoded batch envelope's (command, params)."""
    if command != KV_BATCH_COMMAND:
        raise WireError(f"not a kv_transfer_batch envelope: "
                        f"{command!r}")
    if not params or not isinstance(params[0], list) or not params[0]:
        raise WireError("kv_transfer_batch carries no members")
    members = params[0]
    for i, member in enumerate(members):
        if not isinstance(member, (bytes, bytearray)):
            raise WireError(
                f"kv_transfer_batch member {i} is "
                f"{type(member).__name__}, want bytes")
    return [bytes(m) for m in members]


def decode_kv_transfer(payload) -> dict:
    """Decode and validate one KV-transfer envelope: {transfer_id,
    tenant, start_block, block_tokens, first_token, layout, tokens,
    blocks, final}, every leaf schema-checked (dtype, rank, scale and
    value agreement, uniform block length).  A truncated or foreign
    payload raises WireError instead of reaching a cache."""
    command, params = decode_envelope(payload)
    return validate_kv_transfer_params(command, params)


def validate_kv_transfer_params(command, params) -> dict:
    """The validation body of decode_kv_transfer over an already-decoded
    (command, params), shared with the batch path."""
    if command != KV_TRANSFER_COMMAND:
        raise WireError(f"not a kv_transfer envelope: {command!r}")
    if len(params) < KV_TRANSFER_PARAMS:
        raise WireError(f"kv_transfer envelope short: {len(params)} "
                        f"params")
    (transfer_id, tenant, start_block, block_tokens, first_token,
     layout, token_box, blocks) = params[:KV_TRANSFER_PARAMS]
    try:
        start_block = int(str(start_block))
        block_tokens = int(str(block_tokens))
        first_token = None if str(first_token) == "" \
            else int(str(first_token))
    except (TypeError, ValueError) as exc:
        raise WireError(f"kv_transfer header fields malformed: "
                        f"{exc}") from exc
    if block_tokens < 1 or start_block < 0:
        raise WireError(
            f"kv_transfer header out of range: start_block "
            f"{start_block}, block_tokens {block_tokens}")
    tokens = (token_box or {}).get("tokens") \
        if isinstance(token_box, dict) else None
    if tokens is None or not _is_nd_value(tokens) or \
            not kv_leaf_legal("tokens", tokens.dtype, tokens.ndim):
        raise WireError("kv_transfer tokens missing or not i32[*]")
    if not isinstance(blocks, list):
        raise WireError("kv_transfer blocks must be a list")
    checked = []
    for b, per_layer in enumerate(blocks):
        if not isinstance(per_layer, list) or not per_layer:
            raise WireError(f"kv_transfer block {b} empty")
        layers = []
        for i, entry in enumerate(per_layer):
            if not isinstance(entry, dict) or set(entry) != {"k", "v"}:
                raise WireError(
                    f"kv_transfer block {b} layer {i}: want "
                    f"{{'k','v'}}")
            what = f"block {b} layer {i}"
            k = _check_kv_leaf(entry["k"], what + " k")
            v = _check_kv_leaf(entry["v"], what + " v")
            for name, leaf in (("k", k), ("v", v)):
                rows = leaf["q"] if isinstance(leaf, dict) else leaf
                if rows.shape[1] != block_tokens:
                    raise WireError(
                        f"kv_transfer {what} {name}: {rows.shape[1]} "
                        f"rows, want block_tokens={block_tokens}")
            layers.append({"k": k, "v": v})
        checked.append(layers)
    return {
        "transfer_id": str(transfer_id), "tenant": str(tenant),
        "start_block": start_block, "block_tokens": block_tokens,
        "first_token": first_token,
        "layout": tuple(str(f) for f in (layout or [])),
        "tokens": tokens, "blocks": checked,
        # a ninth "chunk" param marks a non-final stream member; anything
        # else (its absence included) is a complete transfer
        "final": not (len(params) > KV_TRANSFER_PARAMS
                      and str(params[KV_TRANSFER_PARAMS]) == "chunk"),
    }


# Session KV migration: a draining runtime ships each session's pinned
# chain as ordinary chunk-streamed KV_TRANSFER envelopes; three small
# control legs surround them.  The offer carries both token lists a
# session owns (the pinned chain's tokens and the conversation history),
# so the destination re-pins and re-creates the session record at once.
#
#   offer (source -> destination /migrate):
#     [transfer_id, tenant, sid, reply_topic,
#      {"tokens": i32[*]}, {"history": i32[*]}]
#   ack (destination -> reply_topic): [transfer_id, have_blocks]
#     (the leading chain blocks already resident at the destination:
#     the source ships handles below that mark, bytes above it)
#   done (destination -> reply_topic): [transfer_id, installed_blocks]

KV_MIGRATE_COMMAND = "kv_migrate"
KV_MIGRATE_ACK_COMMAND = "kv_migrate_ack"
KV_MIGRATE_DONE_COMMAND = "kv_migrate_done"
KV_MIGRATE_PARAMS = 6       # the offer's required param count


def encode_kv_migrate(transfer_id: str, tenant: str, sid: str,
                      reply_topic: str, tokens, history,
                      trace=None) -> bytes:
    """One session-migration offer envelope (layout above)."""
    tokens = np.asarray(tokens, np.int32)
    history = np.asarray(history, np.int32)
    if tokens.ndim != 1 or history.ndim != 1:
        raise WireError(
            f"kv_migrate tokens/history must be rank 1, got "
            f"{tokens.ndim}/{history.ndim}")
    return encode_envelope(
        KV_MIGRATE_COMMAND,
        [str(transfer_id), str(tenant), str(sid), str(reply_topic),
         {"tokens": tokens}, {"history": history}], trace=trace)


def validate_kv_migrate_params(command, params) -> dict:
    """The decode side of encode_kv_migrate: {transfer_id, tenant, sid,
    reply_topic, tokens, history}, both arrays schema-checked, or
    WireError."""
    if command != KV_MIGRATE_COMMAND:
        raise WireError(f"not a kv_migrate envelope: {command!r}")
    if len(params) < KV_MIGRATE_PARAMS:
        raise WireError(
            f"kv_migrate envelope short: {len(params)} params")
    (transfer_id, tenant, sid, reply_topic,
     token_box, history_box) = params[:KV_MIGRATE_PARAMS]
    arrays = {}
    for name, box in (("tokens", token_box), ("history", history_box)):
        value = (box or {}).get(name) if isinstance(box, dict) else None
        if value is None or not _is_nd_value(value) or \
                not kv_leaf_legal("tokens", value.dtype, value.ndim):
            raise WireError(f"kv_migrate {name} missing or not i32[*]")
        arrays[name] = value
    return {"transfer_id": str(transfer_id), "tenant": str(tenant),
            "sid": str(sid), "reply_topic": str(reply_topic),
            "tokens": arrays["tokens"], "history": arrays["history"]}


def encode_kv_migrate_reply(command: str, transfer_id: str,
                            blocks: int, trace=None) -> bytes:
    """An ack or done leg: [transfer_id, blocks] under `command`
    (KV_MIGRATE_ACK_COMMAND or KV_MIGRATE_DONE_COMMAND)."""
    if command not in (KV_MIGRATE_ACK_COMMAND, KV_MIGRATE_DONE_COMMAND):
        raise WireError(f"not a kv_migrate reply command: {command!r}")
    return encode_envelope(command,
                           [str(transfer_id), str(int(blocks))],
                           trace=trace)


def validate_kv_migrate_reply(command, params) -> tuple:
    """(transfer_id, blocks) of an ack or done leg, or WireError."""
    if command not in (KV_MIGRATE_ACK_COMMAND, KV_MIGRATE_DONE_COMMAND):
        raise WireError(f"not a kv_migrate reply envelope: {command!r}")
    if len(params) < 2:
        raise WireError(
            f"kv_migrate reply short: {len(params)} params")
    try:
        blocks = int(str(params[1]))
    except (TypeError, ValueError) as exc:
        raise WireError(
            f"kv_migrate reply blocks malformed: {exc}") from exc
    if blocks < 0:
        raise WireError(f"kv_migrate reply blocks negative: {blocks}")
    return str(params[0]), blocks


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
