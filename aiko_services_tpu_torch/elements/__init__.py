# Built-in pipeline elements of the port, by class name: the pipeline
# instantiates a definition's elements from here (Pipeline._instantiate).
# Importing this builds no model and no kernel, and imports neither PIL
# nor OpenCV nor sounddevice: PE_WhisperASR, PE_LlamaAgent,
# PE_NeuralTTS, PE_ImageClassify and PE_Detect set their models up when
# their first stream starts, the file, resize and video elements import
# PIL or cv2 inside their calls, and PE_Microphone imports sounddevice
# when its stream starts.

from .audio import (                                        # noqa: F401
    PE_FFT, PE_AudioFilter, PE_AudioResampler, PE_GraphXY, PE_Microphone,
    PE_MicrophoneSim, PE_RemoteReceive, PE_RemoteSend, PE_Speaker,
)
from .common import (                                       # noqa: F401
    PE_0, PE_1, PE_2, PE_3, PE_4, PE_DataDecode, PE_DataEncode,
    PE_GenerateNumbers, PE_Identity, PE_Metrics,
)
from .detect import PE_Detect, PE_LlamaAgent                # noqa: F401
from .image import (                                        # noqa: F401
    PE_ImageAnnotate, PE_ImageClassify, PE_ImageOverlay, PE_ImageReadFile,
    PE_ImageResize, PE_ImageWriteFile,
)
from .speech import (                                       # noqa: F401
    PE_AudioFraming, PE_AudioReadFile, PE_AudioWriteFile, PE_LogMel,
    PE_Synthesize, PE_WhisperASR,
)
from .tts import PE_NeuralTTS                               # noqa: F401
from .video import (                                        # noqa: F401
    PE_Tracker, PE_VideoCameraRead, PE_VideoReadFile, PE_VideoShow,
    PE_VideoWriteFile,
)
from .video_stream import (                                 # noqa: F401
    MJPEGStreamServer, PE_VideoStreamRead, PE_VideoStreamServe,
    PE_VideoStreamWrite, PE_VideoUDPReceive, PE_VideoUDPSend,
)

__all__ = [
    "PE_0", "PE_1", "PE_2", "PE_3", "PE_4", "PE_DataDecode",
    "PE_DataEncode", "PE_GenerateNumbers", "PE_Identity", "PE_Metrics",
    "PE_Detect", "PE_LlamaAgent", "PE_AudioFraming", "PE_AudioReadFile",
    "PE_AudioWriteFile", "PE_LogMel", "PE_MicrophoneSim", "PE_Speaker",
    "PE_Synthesize", "PE_WhisperASR", "PE_Microphone", "PE_FFT",
    "PE_GraphXY", "PE_AudioFilter", "PE_AudioResampler", "PE_RemoteSend",
    "PE_RemoteReceive", "PE_NeuralTTS",
    "PE_ImageAnnotate", "PE_ImageClassify", "PE_ImageOverlay",
    "PE_ImageReadFile", "PE_ImageResize", "PE_ImageWriteFile",
    "PE_Tracker", "PE_VideoCameraRead", "PE_VideoReadFile", "PE_VideoShow",
    "PE_VideoWriteFile",
    "MJPEGStreamServer", "PE_VideoStreamRead", "PE_VideoStreamServe",
    "PE_VideoStreamWrite", "PE_VideoUDPReceive", "PE_VideoUDPSend",
]
