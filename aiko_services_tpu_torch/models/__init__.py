# Models of the port, each at the JAX package's relative path: the shared
# layers, Whisper, Llama, ResNet and the detector.

from . import layers                                        # noqa: F401
from .detector import (                                     # noqa: F401
    DETECTOR_PRESETS, Detector, DetectorConfig, detect, detector_forward,
    detector_init,
)
from .llama import (                                        # noqa: F401
    LLAMA_PRESETS, Llama, LlamaConfig, llama_forward, llama_greedy_decode,
    llama_init,
)
from .resnet import (                                       # noqa: F401
    RESNET_PRESETS, ResNet, ResNetConfig, resnet_features, resnet_forward,
    resnet_init,
)
from .whisper import (                                      # noqa: F401
    WHISPER_PRESETS, Whisper, WhisperConfig, whisper_init,
)
