# Parallel attention of the port.  Only the plain attention that the
# dispatcher's short-sequence path runs is ported so far.

from .ring_attention import attention_reference  # noqa: F401
