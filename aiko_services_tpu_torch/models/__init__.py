# Models of the port, each at the JAX package's relative path: the shared
# layers, Whisper, Llama, the MoE FFN, ResNet, the detector, the
# tokenizers and TTS.  The re-exports are the JAX package's
# models/__init__.py list, plus the port's parameter modules and its
# vision entry points.

from . import layers                                        # noqa: F401
from .detector import (                                     # noqa: F401
    DETECTOR_PRESETS, Detector, DetectorConfig, detect, detector_forward,
    detector_init,
)
from .llama import (                                        # noqa: F401
    LLAMA_PRESETS, Llama, LlamaConfig, init_llama_caches, llama_axes,
    llama_decode_step, llama_forward, llama_greedy_decode, llama_init,
)
from .moe import (                                          # noqa: F401
    MoE, MoeConfig, moe_axes, moe_forward, moe_init,
)
from .resnet import (                                       # noqa: F401
    RESNET_PRESETS, ResNet, ResNetConfig, resnet_axes, resnet_features,
    resnet_forward, resnet_init,
)
from .tokenizer import (                                    # noqa: F401
    BPETokenizer, ByteTokenizer, WhisperTokens, load_tokenizer,
)
from .tts import (                                          # noqa: F401
    TTS, TTS_PRESETS, TTSConfig, predict_durations, regulate, synthesize,
    tts_axes, tts_forward, tts_init,
)
from .whisper import (                                      # noqa: F401
    WHISPER_PRESETS, Whisper, WhisperConfig, decode_step, encode, forward,
    greedy_decode, whisper_axes, whisper_init,
)
