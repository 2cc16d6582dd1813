"""Retry with exponential backoff + jitter for host-side network boundaries.

Same policy as the reference's OpenAI wrapper
(``attack/poisonedRAG_attack_using_GPT.py:323-353``): 6 attempts,
exponential backoff with jitter.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

T = TypeVar("T")


def retry_with_backoff(fn: Callable[[], T], attempts: int = 6,
                       base_delay: float = 1.0, max_delay: float = 30.0,
                       sleep=time.sleep) -> T:
    last_exc: Exception | None = None
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - network boundary
            last_exc = e
            if attempt == attempts - 1:
                break
            delay = min(max_delay, base_delay * (2 ** attempt))
            delay *= 0.5 + random.random()
            sleep(delay)
    raise last_exc  # type: ignore[misc]
