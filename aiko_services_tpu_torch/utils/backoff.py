# Retry backoff shared by the pipeline's remote-hop recovery.
#
# The port's own copy of aiko_services_tpu/utils/backoff.py: the same
# formula, so the same seeded random.Random gives the same delays in both
# packages.

from __future__ import annotations

import random

__all__ = ["jittered_backoff"]


def jittered_backoff(base: float, attempt: int, cap: float,
                     jitter: float, rng: random.Random) -> float:
    """Delay before the attempt-th retry (attempt >= 1): exponential in
    the attempt, capped, stretched by up to `jitter` of itself."""
    delay = min(base * (2 ** (attempt - 1)), cap)
    return delay * (1.0 + jitter * rng.random())
