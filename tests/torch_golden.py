"""The golden trained speech models on the port: the three-word tone
language and the recipes that train the test-preset Whisper, the TTS
acoustic model and the vocoder on it.

The port's copy of tests/test_speech_golden.py's `WORDS`, `word_tone`,
`utterance` and `train_whisper`, and of tests/test_tts.py's
`byte_durations`, `train_tts` and `train_vocoder`: the same corpus, the
same steps, stopping rules and loss thresholds.  The optimizers map
optax onto torch: optax.adam(lr) is torch.optim.Adam(lr, betas (0.9,
0.999), eps 1e-8); the vocoder's multi_transform is two parameter
groups, "freqs" under Adam at 2.0 and the rest under Adam at 3e-3 with
optax's smooth exponential_decay(3e-3, steps // 4, 0.5), a LambdaLR of
0.5 ** (step / (steps // 4)).  Init draws from a torch.Generator seeded
0 on the device, so the trained weights are not JAX's: parity across
packages is by text (training) and by tokens (serving the same npz).

Each trainer takes `device` (None: the card; the tests pass "cpu").
train_whisper trains under torch's deterministic algorithms (on the card
the embedding backward and the loss's gather backward add atomically),
so a card trains the same Whisper in every run: the ASR gates' texts
hang on the trained bits.  The TTS gate (a tone within 60 Hz) does not, and
there the deterministic kernels cost ~4 s on the card, so train_tts and
train_vocoder run the default kernels.
This module imports neither jax nor the JAX package: chip_smoke.py and
aiko_services_tpu_torch/tools/train_vocoder_scale.py reach it through
sys.path, as the repo's tools reach tests/."""

from __future__ import annotations

import contextlib
import itertools
import warnings

import numpy as np
import torch

SAMPLE_RATE = 16000
WORDS = {"alpha": 330.0, "bravo": 550.0, "charlie": 770.0}
MAX_TOKENS = 14
BUCKET = 100            # mel frames (1 s of audio)
TEXTS = [["alpha"], ["bravo"], ["charlie"],
         ["alpha", "bravo"], ["bravo", "charlie"],
         ["charlie", "alpha"], ["alpha", "charlie"],
         ["bravo", "alpha"], ["charlie", "bravo"]]

# the TTS recipe's geometry (tests/test_tts.py)
TTS_MAX_TOKENS = 16
TONE_FRAMES = 25               # 0.25 s word tone at 100 mel frames/s
GAP_FRAMES = 5                 # 0.05 s inter-word gap (the space byte)

WHISPER_STEPS, WHISPER_STOP, WHISPER_FIT = 600, 0.004, 0.05
TTS_STEPS, TTS_STOP, TTS_FIT = 700, 2e-3, 0.05
VOCODER_STEPS, VOCODER_FIT = 9000, 0.02


def whisper_config():
    """The config PE_WhisperASR builds for preset "test", buckets [100]
    and max_tokens 14, in f32 (the element serves it in bf16)."""
    from aiko_services_tpu_torch.models.whisper import WhisperConfig
    return WhisperConfig(n_mels=80, n_audio_ctx=BUCKET // 2,
                         n_text_ctx=MAX_TOKENS + 8, n_vocab=256, dim=64,
                         num_heads=4, enc_layers=2, dec_layers=2,
                         sot=254, eot=255)


def asr_definition(weights: str, frontend: str = "mel", **parameters):
    """tests/test_speech_golden.py's golden pipelines: PE_AudioReadFile →
    PE_LogMel → PE_WhisperASR (frontend "mel"), or the fused µ-law
    frontend's PE_AudioReadFile → PE_WhisperASR ("mulaw"), serving the
    npz at `weights`; `parameters` are more PE_WhisperASR parameters
    (kv_quant)."""
    asr_input = "mel" if frontend == "mel" else "audio"
    elements = [
        {"name": "PE_AudioReadFile", "input": [],
         "output": [{"name": "audio"}, {"name": "sample_rate"}]},
        {"name": "PE_WhisperASR", "input": [{"name": asr_input}],
         "output": [{"name": "tokens"}, {"name": "text"}]},
    ]
    graph = "(PE_AudioReadFile (PE_WhisperASR))"
    if frontend == "mel":
        elements.insert(1, {"name": "PE_LogMel",
                            "input": [{"name": "audio"}],
                            "output": [{"name": "mel"}]})
        graph = "(PE_AudioReadFile (PE_LogMel (PE_WhisperASR)))"
    params = {
        "PE_WhisperASR.preset": "test",
        "PE_WhisperASR.mode": "sync",
        "PE_WhisperASR.max_tokens": MAX_TOKENS,
        "PE_WhisperASR.buckets": [BUCKET],
        "PE_WhisperASR.weights": weights,
        "PE_WhisperASR.tokenizer": "builtin:byte",
    }
    if frontend == "mulaw":
        params.update({"PE_WhisperASR.frontend": "audio",
                       "PE_WhisperASR.wire": "mulaw"})
    params.update({f"PE_WhisperASR.{k}": v for k, v in parameters.items()})
    return {"version": 0, "name": "p_golden", "runtime": "python",
            "graph": [graph], "parameters": params, "elements": elements}


def tts_definition(weights: str, gl_iters: int = 24):
    """tests/test_tts.py's (PE_NeuralTTS) pipeline, serving the npz at
    `weights` in sync mode."""
    return {"version": 0, "name": "p_tts", "runtime": "python",
            "graph": ["(PE_NeuralTTS)"],
            "parameters": {"PE_NeuralTTS.preset": "test",
                           "PE_NeuralTTS.mode": "sync",
                           "PE_NeuralTTS.weights": weights,
                           "PE_NeuralTTS.gl_iters": gl_iters,
                           "PE_NeuralTTS.max_tokens": TTS_MAX_TOKENS},
            "elements": [{"name": "PE_NeuralTTS",
                          "input": [{"name": "text"}],
                          "output": [{"name": "audio"},
                                     {"name": "sample_rate"}]}]}


def dominant_frequency(audio, sample_rate=SAMPLE_RATE) -> float:
    spectrum = np.abs(np.fft.rfft(audio))
    return float(np.fft.rfftfreq(audio.size, 1.0 / sample_rate)[
        spectrum.argmax()])


def word_tone(freq):
    t = np.arange(int(SAMPLE_RATE * 0.25)) / SAMPLE_RATE
    envelope = np.minimum(1.0, 16 * np.minimum(t / 0.25, 1 - t / 0.25))
    return (0.4 * np.sin(2 * np.pi * freq * t) * envelope).astype(
        np.float32)


def utterance(words):
    gap = np.zeros(int(SAMPLE_RATE * 0.05), np.float32)
    chunks = []
    for word in words:
        chunks += [word_tone(WORDS[word]), gap]
    return np.concatenate(chunks[:-1])


def log_mel(wave, device) -> np.ndarray:
    """One waveform's log-mel [T, 80] through the port's frontend on
    `device`, as a host array."""
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    audio = torch.from_numpy(np.asarray(wave, np.float32)[None]).to(device)
    return log_mel_spectrogram(audio)[0].cpu().numpy()


def fused_mel(wave, device) -> np.ndarray:
    """The log-mel [BUCKET, 80] the fused µ-law frontend computes for
    `wave` (PE_WhisperASR frontend "audio", wire "mulaw"): its µ-law
    codes padded to the bucket with the code of silence (collate_audio),
    expanded and taken through the log-mel on `device`, as a host
    array."""
    from aiko_services_tpu_torch.elements.speech import collate_audio
    from aiko_services_tpu_torch.ops.audio import (log_mel_spectrogram,
                                                   mulaw_decode)
    codes = collate_audio([wave], 1, BUCKET, "mulaw", torch.device(device))
    return log_mel_spectrogram(mulaw_decode(codes))[0].cpu().numpy()


def byte_durations(words):
    """Ground-truth per-byte durations for a word sequence: each word's
    25 tone frames split over its bytes, 5 frames per separating space,
    the utterance() geometry."""
    durations = []
    for w, word in enumerate(words):
        if w:
            durations.append(GAP_FRAMES)
        count = len(word)
        base, remainder = divmod(TONE_FRAMES, count)
        durations += [base + (1 if i < remainder else 0)
                      for i in range(count)]
    return durations


def _adam(params, lr):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 (added to sqrt(v̂))."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms for the length of a training
    loop (train_whisper's), the previous setting restored after.  warn_only: cuBLAS is
    deterministic on one stream without CUBLAS_WORKSPACE_CONFIG, whose
    absence torch would otherwise refuse (its warning is muted)."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE")
            yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def _trainable(module):
    for param in module.parameters():
        param.requires_grad_(True)
    return module


def _frozen(module):
    for param in module.parameters():
        param.requires_grad_(False)
        param.grad = None
    return module


def train_whisper(device=None, stats: dict | None = None):
    """Overfit the test-preset Whisper on every 1-2 word utterance (600
    Adam steps at 2e-3, stopping under a loss of 0.004: margin for bf16
    serving).  Returns the trained module (f32, on `device`); `stats`,
    when given, receives the steps taken, the last loss and the seconds
    the steps took.

    Departure from JAX's recipe (tests/test_speech_golden.py
    train_whisper), which trains on zero-padded mel alone: each text is
    a batch row twice, once as zero-padded mel (what the host-mel path
    collates) and once as the mel the fused µ-law frontend computes
    (fused_mel: the µ-law noise floor and the padded silence, whose
    normalised mel is not zero).  On zero-padded mel alone the fused
    text depended on the init (ROADMAP Queue 3 item 19).  On the float
    mel of the silence-padded audio alone the host-mel path misread
    ("bravo alpha" for "bravo"); beside zero-padded mel it still
    missed the fused text on the card's model and at seed 1 on the
    CPU ("charlie" for "charlie alpha"), where this recipe held the
    three gates at seeds 0-8 on the CPU."""
    import time

    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    from aiko_services_tpu_torch.models.whisper import forward, whisper_init

    device = resolve_device(device)
    config = whisper_config()
    tokenizer = ByteTokenizer()
    mels, inputs, targets = [], [], []
    for words in TEXTS:
        wave = utterance(words)
        mel = log_mel(wave, device)
        buffer = np.zeros((BUCKET, 80), np.float32)
        frames = min(mel.shape[0], BUCKET)
        buffer[:frames] = mel[:frames]              # zero-pad like collate
        ids = tokenizer.encode(" ".join(words))
        row_in = ([config.sot] + ids +
                  [config.eot] * (MAX_TOKENS + 1))[:MAX_TOKENS + 1]
        row_out = (ids + [config.eot] * (MAX_TOKENS + 1))[:MAX_TOKENS + 1]
        # each text twice: as the host-mel path collates it, and as the
        # fused µ-law frontend computes it
        for row in (buffer, fused_mel(wave, device)):
            mels.append(row)
            inputs.append(row_in)
            targets.append(row_out)
    mels = torch.from_numpy(np.stack(mels)).to(device)
    inputs = torch.tensor(inputs, dtype=torch.int64, device=device)
    targets = torch.tensor(targets, dtype=torch.int64, device=device)

    params = _trainable(whisper_init(
        torch.Generator(device=device).manual_seed(0), config,
        device=device))
    optim = _adam(params.parameters(), 2e-3)
    loss = None
    steps = 0
    start = time.perf_counter()
    with _deterministic():
        for _ in range(WHISPER_STEPS):
            optim.zero_grad(set_to_none=True)
            logits = forward(params, config, mels, inputs)
            logp = torch.log_softmax(logits.float(), dim=-1)
            loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
            loss.backward()
            optim.step()
            steps += 1
            if float(loss.detach()) < WHISPER_STOP:   # margin for bf16
                break
    seconds = time.perf_counter() - start
    loss = float(loss.detach())
    if stats is not None:
        stats.update(steps=steps, loss=loss, seconds=seconds)
    assert loss < WHISPER_FIT, f"golden model failed to fit: loss={loss}"
    return _frozen(params)


def train_tts(exclude: list | None = None, device=None,
              stats: dict | None = None):
    """FastSpeech-style overfit on the tone language: mel loss under
    teacher-forced ground-truth durations + 0.1 x a supervised
    log-duration loss (700 Adam steps at 3e-3, stopping under 2e-3).
    `exclude` drops one text from the corpus, to hold it out for the
    MCD check.  Returns the trained TTS module (f32, on `device`)."""
    import time

    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
    from aiko_services_tpu_torch.models.tts import (
        TTS_PRESETS, predict_durations, tts_forward, tts_init)

    device = resolve_device(device)
    config = TTS_PRESETS["test"]
    tokenizer = ByteTokenizer()
    texts = TEXTS
    if exclude is not None:
        texts = [t for t in texts if t != exclude]
        assert len(texts) == 8, f"exclude {exclude} not in corpus"
    token_rows, dur_rows, mel_rows, frame_mask, token_mask = \
        [], [], [], [], []
    for words in texts:
        ids = tokenizer.encode(" ".join(words))[:TTS_MAX_TOKENS]
        durations = byte_durations(words)[:len(ids)]
        total = int(sum(durations))
        mel = log_mel(utterance(words), device)
        buffer = np.zeros((config.max_frames, config.n_mels), np.float32)
        frames = min(mel.shape[0], total, config.max_frames)
        buffer[:frames] = mel[:frames]
        mask = np.zeros((config.max_frames,), np.float32)
        mask[:frames] = 1.0
        pad = TTS_MAX_TOKENS - len(ids)
        token_rows.append(ids + [0] * pad)
        dur_rows.append(durations + [0] * pad)
        token_mask.append([1.0] * len(ids) + [0.0] * pad)
        mel_rows.append(buffer)
        frame_mask.append(mask)
    tokens = torch.tensor(token_rows, dtype=torch.int64, device=device)
    true_durations = torch.tensor(dur_rows, dtype=torch.float32,
                                  device=device)
    target = torch.from_numpy(np.stack(mel_rows)).to(device)
    fmask = torch.from_numpy(np.stack(frame_mask)).to(device)[..., None]
    tmask = torch.tensor(token_mask, dtype=torch.float32, device=device)
    log_true = torch.log(torch.clamp(true_durations, min=1.0))

    params = _trainable(tts_init(
        torch.Generator(device=device).manual_seed(0), config,
        device=device))
    optim = _adam(params.parameters(), 3e-3)
    loss = None
    steps = 0
    start = time.perf_counter()
    for _ in range(TTS_STEPS):
        optim.zero_grad(set_to_none=True)
        mel, _ = tts_forward(params, config, tokens,
                             durations=true_durations)
        mel_loss = torch.sum(fmask * (mel - target) ** 2) / \
            (torch.sum(fmask) * config.n_mels)
        log_d, _ = predict_durations(params, config, tokens)
        dur_loss = torch.sum(tmask * (log_d - log_true) ** 2) / \
            torch.sum(tmask)
        loss = mel_loss + 0.1 * dur_loss
        loss.backward()
        optim.step()
        steps += 1
        if float(loss.detach()) < TTS_STOP:
            break
    seconds = time.perf_counter() - start
    loss = float(loss.detach())
    if stats is not None:
        stats.update(steps=steps, loss=loss, seconds=seconds)
    assert loss < TTS_FIT, f"TTS failed to fit: {loss}"
    return _frozen(params)


def vocoder_corpus(exclude: list) -> list:
    """The vocoder's wide corpus: the nine texts less `exclude`, and
    every 3-word tone sequence whose adjacencies do not hold the
    held-out pair."""
    texts = [t for t in TEXTS if t != exclude]

    def leaks(seq):
        return any(list(seq[i:i + len(exclude)]) == exclude
                   for i in range(len(seq) - len(exclude) + 1))

    for seq in itertools.product(sorted(WORDS), repeat=3):
        if not leaks(seq):
            texts.append(list(seq))
    return texts


def train_vocoder(exclude: list, vocoder_config=None, texts=None,
                  steps: int = VOCODER_STEPS, window: int = 96,
                  device=None, stats: dict | None = None):
    """Overfit the oscillator-bank vocoder on the corpus less the
    held-out text: (ground-truth log-mel, waveform) pairs, loss = the
    mel re-analysis L2 over each utterance's frames.  The oscillator
    frequencies train at their own learning rate (Adam at 2.0), the rest
    under Adam at 3e-3 decaying by half every steps // 4.  Returns
    (trained module, config)."""
    import time

    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.models.vocoder import (
        VOCODER_PRESETS, vocoder_forward, vocoder_init)
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram

    device = resolve_device(device)
    vocoder_config = vocoder_config or VOCODER_PRESETS["test"]
    n_mels = 80
    if texts is None:
        texts = vocoder_corpus(exclude)
    hop = vocoder_config.hop
    # window must cover the longest utterance (3 words = 90 frames)
    mel_rows, wave_rows, frame_counts = [], [], []
    for words in texts:
        wave = np.asarray(utterance(words), np.float32)
        mel = log_mel(wave, device)
        frames = min(mel.shape[0], window)
        mel_buf = np.zeros((window, n_mels), np.float32)
        mel_buf[:frames] = mel[:frames]
        wave_buf = np.zeros((window * hop,), np.float32)
        count = min(wave.shape[0], frames * hop)
        wave_buf[:count] = wave[:count]
        mel_rows.append(mel_buf)
        wave_rows.append(wave_buf)
        frame_counts.append(frames)
    mels = torch.from_numpy(np.stack(mel_rows)).to(device)
    waves = torch.from_numpy(np.stack(wave_rows)).to(device)
    mask = torch.from_numpy((np.arange(window)[None, :] <
                             np.asarray(frame_counts)[:, None])
                            .astype(np.float32)).to(device)
    true_mel = log_mel_spectrogram(waves)

    params = _trainable(vocoder_init(
        torch.Generator(device=device).manual_seed(0), vocoder_config,
        device=device))
    net = [p for name, p in params.named_parameters()
           if not name.startswith("freqs")]
    optim = torch.optim.Adam(
        [{"params": net, "lr": 3e-3}, {"params": [params.freqs], "lr": 2.0}],
        betas=(0.9, 0.999), eps=1e-8)
    transition = steps // 4
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optim, [lambda step: 0.5 ** (step / transition), lambda step: 1.0])

    loss = None
    start = time.perf_counter()
    for _ in range(steps):
        optim.zero_grad(set_to_none=True)
        pred = vocoder_forward(params, vocoder_config, mels)
        pred_mel = log_mel_spectrogram(pred)
        frames = min(pred_mel.shape[1], mask.shape[1])
        m = mask[:, :frames, None]
        loss = torch.sum(m * (pred_mel[:, :frames] -
                              true_mel[:, :frames]) ** 2) / \
            (torch.sum(m) * n_mels)
        loss.backward()
        optim.step()
        schedule.step()
    seconds = time.perf_counter() - start
    loss = float(loss.detach())
    if stats is not None:
        stats.update(steps=steps, loss=loss, seconds=seconds)
    assert loss < VOCODER_FIT, f"vocoder failed to fit: {loss}"
    return _frozen(params), vocoder_config


def held_out_mcd(params, config, held_out=("alpha", "charlie"),
                 device=None) -> float:
    """Copy-synthesis MCD (dB) of the vocoder on a held-out text: its
    ground-truth log-mel in, the waveform's re-analysed log-mel against
    it (ops/audio.py mel_cepstral_distortion)."""
    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.models.vocoder import vocoder_forward
    from aiko_services_tpu_torch.ops.audio import mel_cepstral_distortion

    device = resolve_device(device)
    mel_true = log_mel(utterance(list(held_out)), device)
    with torch.no_grad():
        audio = vocoder_forward(params, config, torch.from_numpy(
            mel_true[None]).to(device))[0].cpu().numpy()
    mel_out = log_mel(audio, device)
    frames = min(mel_out.shape[0], mel_true.shape[0])
    return mel_cepstral_distortion(mel_out[:frames], mel_true[:frames])


def griffin_lim_mcd(n_iter: int, held_out=("alpha", "charlie"),
                    device=None) -> float:
    """The same held-out copy synthesis through Griffin-Lim at `n_iter`
    rounds (the weight-free baseline the vocoder must beat)."""
    from aiko_services_tpu_torch import resolve_device
    from aiko_services_tpu_torch.ops.audio import (
        WHISPER_HOP, griffin_lim, mel_cepstral_distortion, mel_to_linear)

    device = resolve_device(device)
    mel_true = log_mel(utterance(list(held_out)), device)
    frames = mel_true.shape[0]
    with torch.no_grad():
        magnitude = mel_to_linear(torch.from_numpy(mel_true[None]).to(device))
        wave = griffin_lim(magnitude, n_iter=n_iter)[0].cpu().numpy()
    mel = log_mel(wave[:frames * WHISPER_HOP], device)
    return mel_cepstral_distortion(mel, mel_true)
