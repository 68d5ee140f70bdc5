"""Retry / backoff / deadline wrappers (port of
``raft_tpu.resilience.retry``).

- :class:`RetryPolicy` — jittered exponential backoff; only exceptions in
  ``retryable`` are retried (``TransientFault`` and ``OSError`` by
  default; logic errors and corruption are deterministic and are not).
- :class:`Deadline` — a wall-clock budget threaded through retries: the
  sleep before an attempt never overshoots it, and an expired deadline
  raises :class:`DeadlineExceededError` instead of starting an attempt.
- :func:`retry_call` — run a thunk under a policy and a deadline.

The JAX package counts re-attempts and give-ups in its observability
registry (``resilience.retry.<site>`` / ``resilience.giveup.<site>``); the
port has no registry yet, so nothing is counted here.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from raft_tpu_torch.core.error import RaftError
from raft_tpu_torch.resilience.faults import TransientFault

T = TypeVar("T")


class DeadlineExceededError(RaftError):
    """The operation's time budget ran out (attempts may remain)."""


class Deadline:
    """A monotonic wall-clock budget: ``Deadline(5.0)`` expires 5 s after
    construction, ``Deadline(None)`` never (the default everywhere).  Pass
    one through nested calls so one budget bounds the whole operation."""

    __slots__ = ("_expires_at", "_clock")

    def __init__(self, seconds: Optional[float],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._expires_at = (None if seconds is None
                            else clock() + float(seconds))

    @classmethod
    def unlimited(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> float:
        """Seconds left (``inf`` for unlimited, clamped at 0.0)."""
        if self._expires_at is None:
            return float("inf")
        return max(0.0, self._expires_at - self._clock())

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        """Raise :class:`DeadlineExceededError` if the budget is spent."""
        if self.expired:
            raise DeadlineExceededError(f"deadline exceeded before {what}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: attempt ``i`` (1-based) sleeps
    ``base_delay * multiplier**(i-1)`` capped at ``max_delay``, scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]`` (deterministic with a
    seeded ``rng``).  ``max_attempts`` counts all attempts (1 = no
    retry)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    retryable: Tuple[Type[BaseException], ...] = (TransientFault, OSError)
    # deterministic failures inside otherwise-retryable families: a
    # missing file will still be missing on attempt 2
    non_retryable: Tuple[Type[BaseException], ...] = (FileNotFoundError,)

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        """Backoff before attempt ``attempt + 1`` (attempt is 1-based)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            u = rng.random() if rng is not None else random.random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(d, 0.0)

    def is_retryable(self, exc: BaseException) -> bool:
        return (isinstance(exc, self.retryable)
                and not isinstance(exc, self.non_retryable))


DEFAULT_POLICY = RetryPolicy()

# test seam: monkeypatch to a no-op to run backoff schedules instantly
_sleep = time.sleep


def retry_call(fn: Callable[..., T], *args, site: str,
               policy: Optional[RetryPolicy] = None,
               deadline: Optional[Deadline] = None,
               rng: Optional[random.Random] = None, **kwargs) -> T:
    """Call ``fn(*args, **kwargs)`` under ``policy`` and ``deadline``; on
    giving up (attempts exhausted, a non-retryable error, or the deadline
    spent) the last error, or :class:`DeadlineExceededError`,
    propagates.  ``site`` names the operation in the deadline's error."""
    policy = policy or DEFAULT_POLICY
    deadline = deadline or Deadline.unlimited()
    attempt = 0
    while True:
        attempt += 1
        deadline.check(f"{site} attempt {attempt}")
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - classified below
            if (not policy.is_retryable(e)
                    or attempt >= policy.max_attempts):
                raise
            pause = min(policy.delay(attempt, rng), deadline.remaining())
            if pause > 0.0:
                _sleep(pause)


def retryable(site: str, *, policy: Optional[RetryPolicy] = None):
    """Decorator form of :func:`retry_call`; the wrapped function gains
    optional ``retry_policy=`` / ``deadline=`` keyword-only arguments."""
    def wrap(fn: Callable[..., T]) -> Callable[..., T]:
        def inner(*args, retry_policy: Optional[RetryPolicy] = None,
                  deadline: Optional[Deadline] = None, **kwargs) -> T:
            return retry_call(fn, *args, site=site,
                              policy=retry_policy or policy,
                              deadline=deadline, **kwargs)
        inner.__name__ = fn.__name__
        inner.__doc__ = fn.__doc__
        inner.__wrapped__ = fn
        return inner
    return wrap
