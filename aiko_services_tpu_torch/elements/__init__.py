# Pipeline elements of the port.  The PipelineElement base arrives with
# the host-plane slice; PE_WhisperASR's batched program is here now.

from .speech import PE_WhisperASR  # noqa: F401
