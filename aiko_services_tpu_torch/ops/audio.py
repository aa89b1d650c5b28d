# Audio DSP ops: the Whisper log-mel frontend and the 8-bit wire codecs.
#
# Counterpart of aiko_services_tpu/ops/audio.py: the frontend runs on
# the device inside the batched ASR program, so samples go from the wire
# to the encoder without a host feature pass.  The framing is the
# reference's own (reflect pad of n_fft // 2, the periodic Hann window
# hanning(n_fft + 1)[:-1], rfft, drop of the last frame, the clamp at
# log-max - 8 per batch item), written out rather than taken from
# torch.stft's defaults.  The inverse path (the TTS leg: mel → linear
# magnitude → Griffin-Lim) is the reference's too: its overlap-add is
# F.fold (col2im: no atomics, so the card sums in a fixed order) over the
# window-square envelope clamped at 1e-8, where torch.istft would raise
# on a NOLA failure.  Host-side codecs stay numpy.

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["mel_filterbank", "stft", "log_mel_spectrogram", "stft_complex",
           "istft", "mel_inverse_filterbank", "mel_to_linear",
           "griffin_lim", "mel_cepstral_distortion", "mulaw_encode",
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


# device copies of the numpy constants, by (name, arguments, device,
# dtype): a Griffin-Lim loop reads the window and the envelope every
# round, and a host-to-device copy per round would wait for the card
_DEVICE_CONSTANTS: dict = {}


def _on_device(key, make, device, dtype=torch.float32) -> torch.Tensor:
    full_key = (key, str(device), dtype)
    tensor = _DEVICE_CONSTANTS.get(full_key)
    if tensor is None:
        tensor = torch.from_numpy(np.array(make())).to(device, dtype)
        _DEVICE_CONSTANTS[full_key] = tensor
    return tensor


def _window(n_fft: int, device, dtype) -> torch.Tensor:
    return _on_device(("hann", n_fft), lambda: _hann(n_fft), device, dtype)


def stft_complex(audio, n_fft: int = WHISPER_N_FFT, hop: int = WHISPER_HOP):
    """audio: [B, T_samples] → complex spectrum [B, T_frames, n_fft//2+1]
    (Hann window, centred by reflect padding: the invertible counterpart
    of stft())."""
    pad = n_fft // 2
    audio = torch.nn.functional.pad(audio[:, None, :], (pad, pad),
                                    mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop)          # [B, frames, n_fft]
    return torch.fft.rfft(frames * _window(n_fft, audio.device,
                                           audio.dtype), dim=-1)


def stft(audio, n_fft: int = WHISPER_N_FFT, hop: int = WHISPER_HOP):
    """audio: [B, T_samples] f32 → magnitude² [B, T_frames, n_fft//2+1].
    Hann window, centred (reflect padding), matching whisper's
    frontend."""
    return stft_complex(audio, n_fft, hop).abs() ** 2


@functools.lru_cache(maxsize=16)
def _envelope(n_fft: int, hop: int, num_frames: int) -> np.ndarray:
    """The window-square overlap-add sum [n_fft + hop * (frames - 1)],
    in f32, frame after frame as the reference's scatter-add sums it."""
    square = _hann(n_fft) * _hann(n_fft)
    norm = np.zeros((n_fft + hop * (num_frames - 1),), np.float32)
    for t in range(num_frames):
        norm[t * hop:t * hop + n_fft] += square
    norm.setflags(write=False)
    return norm


def istft(spectrum, n_fft: int = WHISPER_N_FFT, hop: int = WHISPER_HOP):
    """Inverse STFT by windowed overlap-add with window-square
    normalization (clamped at 1e-8, so a sample no window covers comes
    out 0 instead of raising).  spectrum: [B, T_frames, n_fft//2+1]
    complex → audio [B, hop * (T_frames - 1)]."""
    frames = torch.fft.irfft(spectrum, n=n_fft, dim=-1)   # [B, T, n_fft]
    frames = frames * _window(n_fft, frames.device, frames.dtype)
    _, num_frames, _ = frames.shape
    length = n_fft + hop * (num_frames - 1)
    audio = torch.nn.functional.fold(
        frames.transpose(1, 2), output_size=(1, length),
        kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]
    norm = _on_device(("envelope", n_fft, hop, num_frames),
                      lambda: _envelope(n_fft, hop, num_frames),
                      frames.device, frames.dtype)
    audio = audio / torch.clamp(norm, min=1e-8)[None, :]
    pad = n_fft // 2
    return audio[:, pad:length - pad]


@functools.lru_cache(maxsize=4)
def mel_inverse_filterbank(num_mels: int = 80, n_fft: int = WHISPER_N_FFT,
                           sample_rate: int = WHISPER_SAMPLE_RATE):
    """Pseudo-inverse of the mel filterbank: [num_mels, n_fft//2+1]
    (numpy f32 constant).  rcond truncates the near-zero singular values
    that make the plain pseudo-inverse ring in the Slaney linear-to-log
    transition (~1-1.3 kHz)."""
    bank = np.linalg.pinv(mel_filterbank(num_mels, n_fft, sample_rate),
                          rcond=1e-2).astype(np.float32)
    bank.setflags(write=False)
    return bank


def mel_to_linear(log_mel, num_mels: int = 80, n_fft: int = WHISPER_N_FFT,
                  sample_rate: int = WHISPER_SAMPLE_RATE):
    """Invert whisper's log-mel normalization to a linear magnitude
    estimate: [B, T, mels] → [B, T, n_fft//2+1]."""
    log10 = log_mel * 4.0 - 4.0                  # undo (x + 4) / 4
    mels = torch.pow(10.0, log10)                # undo log10
    inverse = _on_device(("mel_inverse", num_mels, n_fft, sample_rate),
                         lambda: mel_inverse_filterbank(
                             num_mels, n_fft, sample_rate),
                         mels.device, mels.dtype)
    linear = torch.matmul(mels, inverse)
    return torch.sqrt(torch.clamp(linear, min=0.0))   # power → magnitude


def griffin_lim(magnitude, n_iter: int = 32, n_fft: int = WHISPER_N_FFT,
                hop: int = WHISPER_HOP):
    """Phase recovery: magnitude [B, T, n_fft//2+1] → audio [B, samples],
    classic Griffin-Lim: `n_iter` rounds of analysis, phase s / max(|s|,
    1e-8), and resynthesis at the target magnitude, in complex64."""
    target = magnitude.to(torch.complex64)
    audio = istft(target, n_fft, hop)
    for _ in range(int(n_iter)):
        spectrum = stft_complex(audio, n_fft, hop)
        phase = spectrum / torch.clamp(spectrum.abs(), min=1e-8)
        t = min(phase.shape[1], target.shape[1])
        audio = istft(target[:, :t] * phase[:, :t], n_fft, hop)
    return audio


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


def mel_cepstral_distortion(mel_a, mel_b, n_coeffs: int = 13) -> float:
    """MCD (dB) between two log_mel_spectrogram outputs [T, n_mels] (host,
    numpy f64): the whisper normalization undone to log10, an orthonormal
    DCT over the mel axis, c0 (loudness) dropped, the distance averaged
    over the frames both have; inf when they share none."""
    a = np.asarray(mel_a, np.float64) * 4.0 - 4.0      # → log10 mel
    b = np.asarray(mel_b, np.float64) * 4.0 - 4.0
    frames = min(a.shape[0], b.shape[0])
    if frames == 0:
        return float("inf")
    a, b = a[:frames], b[:frames]
    n_mels = a.shape[1]
    k = np.arange(n_mels)[None, :]
    i = np.arange(n_mels)[:, None]
    dct = np.cos(np.pi * i * (2 * k + 1) / (2 * n_mels)) * \
        np.sqrt(2.0 / n_mels)
    dct[0] *= np.sqrt(0.5)
    cep_a = a @ dct.T[:, :n_coeffs + 1]
    cep_b = b @ dct.T[:, :n_coeffs + 1]
    diff = cep_a[:, 1:] - cep_b[:, 1:]                 # drop c0
    # 10 sqrt(2) / ln 10 on ln-cepstra == 10 sqrt(2) on log10-cepstra
    return float(10.0 * np.sqrt(2.0) *
                 np.mean(np.sqrt(np.sum(diff ** 2, axis=1))))


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
