# Audio DSP ops: the Whisper log-mel frontend and the 8-bit wire codecs.
#
# Counterpart of aiko_services_tpu/ops/audio.py, main-path subset: the
# frontend runs on the device inside the batched ASR program, so samples
# go from the wire to the encoder without a host feature pass.  The
# framing is the reference's own (reflect pad of n_fft // 2, the periodic
# Hann window hanning(n_fft + 1)[:-1], rfft, drop of the last frame, the
# clamp at log-max - 8 per batch item), written out rather than taken
# from torch.stft's defaults.  Host-side codecs stay numpy.

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["mel_filterbank", "stft", "log_mel_spectrogram", "mulaw_encode",
           "mulaw_decode", "mel_i8_encode", "mel_i8_decode", "mel_i8_pack",
           "mel_i8_unpack", "MULAW_MU", "WHISPER_SAMPLE_RATE",
           "WHISPER_N_FFT", "WHISPER_HOP"]

WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_HOP = 160

# Slaney mel scale (librosa default, what Whisper's frontend uses):
# linear below 1 kHz, logarithmic above.
_MIN_LOG_HZ = 1000.0
_LIN_SLOPE = 3.0 / 200.0                      # mels per Hz below 1 kHz
_MIN_LOG_MEL = _MIN_LOG_HZ * _LIN_SLOPE       # 15.0
_LOG_STEP = math.log(6.4) / 27.0


def _hz_to_mel(hz: float) -> float:
    if hz < _MIN_LOG_HZ:
        return hz * _LIN_SLOPE
    return _MIN_LOG_MEL + math.log(hz / _MIN_LOG_HZ) / _LOG_STEP


def _mel_to_hz(mels):
    linear = mels / _LIN_SLOPE
    log = _MIN_LOG_HZ * np.exp(_LOG_STEP * (mels - _MIN_LOG_MEL))
    return np.where(mels < _MIN_LOG_MEL, linear, log)


@functools.lru_cache(maxsize=8)
def mel_filterbank(num_mels: int = 80, n_fft: int = WHISPER_N_FFT,
                   sample_rate: int = WHISPER_SAMPLE_RATE,
                   fmin: float = 0.0, fmax: float | None = None):
    """Slaney-scale triangular mel filterbank: [n_fft//2+1, num_mels]
    (numpy f32, a constant; read-only so the cached array is shared
    safely)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    num_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, num_bins)
    mel_points = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                             num_mels + 2)
    hz_points = _mel_to_hz(mel_points)

    lower = hz_points[:-2][None, :]
    centre = hz_points[1:-1][None, :]
    upper = hz_points[2:][None, :]
    freqs = fft_freqs[:, None]
    up_slope = (freqs - lower) / np.maximum(centre - lower, 1e-10)
    down_slope = (upper - freqs) / np.maximum(upper - centre, 1e-10)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    enorm = 2.0 / (hz_points[2:] - hz_points[:-2])   # Slaney area norm
    bank = (weights * enorm[None, :]).astype(np.float32)
    bank.setflags(write=False)
    return bank


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int):
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    window.setflags(write=False)
    return window


def stft(audio, n_fft: int = WHISPER_N_FFT, hop: int = WHISPER_HOP):
    """audio: [B, T_samples] f32 → magnitude² [B, T_frames, n_fft//2+1].
    Hann window, centred (reflect padding), matching whisper's
    frontend."""
    pad = n_fft // 2
    audio = torch.nn.functional.pad(audio[:, None, :], (pad, pad),
                                    mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop)          # [B, frames, n_fft]
    window = torch.from_numpy(_hann(n_fft).copy()).to(audio.device,
                                                      audio.dtype)
    spectrum = torch.fft.rfft(frames * window, dim=-1)
    return spectrum.abs() ** 2


def log_mel_spectrogram(audio, num_mels: int = 80,
                        n_fft: int = WHISPER_N_FFT,
                        hop: int = WHISPER_HOP,
                        sample_rate: int = WHISPER_SAMPLE_RATE):
    """audio: [B, T_samples] float in [-1, 1] → log-mel
    [B, T_frames, mels] f32 (whisper normalization: log10, clamp to
    max - 8 per batch item, scale to ~[-1, 1])."""
    power = stft(audio.float(), n_fft, hop)
    power = power[:, :-1]         # whisper drops the final frame
    bank = torch.from_numpy(
        mel_filterbank(num_mels, n_fft, sample_rate).copy()).to(
            power.device)
    mels = torch.matmul(power, bank)
    log_spec = torch.log10(torch.clamp(mels, min=1e-10))
    log_spec = torch.maximum(
        log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# -- 8-bit audio wire format -------------------------------------------------
# G.711-style mu-law companding: the host→device ASR wire carries uint8
# codes (half of int16) and the device expands them inside the batched
# frontend program.

MULAW_MU = 255.0


def mulaw_encode(audio):
    """float [-1, 1] or int16 audio → uint8 mu-law codes (host, numpy)."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    else:
        audio = np.clip(audio.astype(np.float32), -1.0, 1.0)
    compressed = np.sign(audio) * (
        np.log1p(MULAW_MU * np.abs(audio)) / np.log1p(MULAW_MU))
    return np.round((compressed + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode(codes):
    """uint8 mu-law codes (tensor) → float32 [-1, 1] on the codes'
    device."""
    x = codes.float() * (1.0 / 127.5) - 1.0
    return torch.sign(x) * torch.expm1(
        x.abs() * math.log1p(MULAW_MU)) * (1.0 / MULAW_MU)


# -- 8-bit mel wire format ---------------------------------------------------
# Absmax int8 with one scale PER MEL FRAME (row): each 10 ms slice
# quantizes against its own dynamic range.  Packed rows [T, num_mels + 4]:
# int8 codes plus each row's f32 scale as its trailing 4 bytes (the i8mel
# wire codec, transport/wire.py).  Host-side numpy: the transport never
# touches the card.

def mel_i8_encode(mel):
    """float [T, M] log-mel → (int8 codes [T, M], float32 scales [T]).
    Non-finite entries saturate (±inf) or zero (NaN) instead of
    poisoning the row's scale."""
    x = np.asarray(mel, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError(f"mel_i8_encode wants [T, M], got {x.shape}")
    finite = np.where(np.isfinite(x), np.abs(x), 0.0)
    scales = finite.max(axis=1) / 127.0 if x.shape[1] else \
        np.zeros((x.shape[0],), np.float32)
    scales = np.where((scales > 0.0) & np.isfinite(scales),
                      scales, 1.0).astype(np.float32)
    bound = 127.0 * scales[:, None]
    x = np.clip(np.nan_to_num(x, nan=0.0, posinf=np.inf,
                              neginf=-np.inf), -bound, bound)
    codes = np.round(x / scales[:, None]).astype(np.int8)
    return codes, scales


def mel_i8_decode(codes, scales):
    """(int8 codes [T, M], float32 scales [T]) → float32 [T, M]."""
    return np.asarray(codes, np.float32) * \
        np.asarray(scales, np.float32)[:, None]


def mel_i8_pack(mel):
    """float [T, M] → packed int8 [T, M + 4] (codes + per-row scale
    bytes): the single-buffer form the wire envelope ships."""
    codes, scales = mel_i8_encode(mel)
    scale_bytes = scales.view(np.int8).reshape(-1, 4)
    return np.concatenate([codes, scale_bytes], axis=1)


def mel_i8_unpack(packed):
    """packed int8 [T, M + 4] → float32 [T, M] (codes times each row's
    scale)."""
    packed = np.asarray(packed, np.int8)
    if packed.ndim != 2 or packed.shape[1] < 5:
        raise ValueError(
            f"mel_i8_unpack wants packed [T, M+4], got {packed.shape}")
    codes = packed[:, :-4]
    scales = np.ascontiguousarray(packed[:, -4:]).view(
        np.float32).reshape(-1)
    return mel_i8_decode(codes, scales)
