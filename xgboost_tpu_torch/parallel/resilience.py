"""Bounded retries with exponential backoff and seeded jitter.

The port's copy of the JAX package's ``RetryPolicy``
(``parallel/resilience.py``), which its resilient collectives and the
serving client share. Only the policy is here: the serving client
(``serve/client.py``) retries a shed request under it. The resilient
collectives are ROADMAP A.8.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule with exponential backoff + deterministic
    jitter (seeded, so a run replays identically)."""

    max_retries: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    jitter: float = 0.5           # fraction of the delay randomized

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())
