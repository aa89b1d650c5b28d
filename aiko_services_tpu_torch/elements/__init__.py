# Built-in pipeline elements of the port, by class name: the pipeline
# instantiates a definition's elements from here (Pipeline._instantiate).
# Importing this builds no model and no kernel; PE_WhisperASR and
# PE_LlamaAgent set their models up when their first stream starts.

from .audio import PE_MicrophoneSim, PE_Speaker             # noqa: F401
from .common import (                                       # noqa: F401
    PE_0, PE_1, PE_2, PE_3, PE_4, PE_DataDecode, PE_DataEncode,
    PE_GenerateNumbers, PE_Identity, PE_Metrics,
)
from .detect import PE_LlamaAgent                           # noqa: F401
from .speech import (                                       # noqa: F401
    PE_AudioFraming, PE_AudioReadFile, PE_AudioWriteFile, PE_LogMel,
    PE_Synthesize, PE_WhisperASR,
)

__all__ = [
    "PE_0", "PE_1", "PE_2", "PE_3", "PE_4", "PE_DataDecode",
    "PE_DataEncode", "PE_GenerateNumbers", "PE_Identity", "PE_Metrics",
    "PE_LlamaAgent", "PE_AudioFraming", "PE_AudioReadFile",
    "PE_AudioWriteFile", "PE_LogMel", "PE_MicrophoneSim", "PE_Speaker",
    "PE_Synthesize", "PE_WhisperASR",
]
