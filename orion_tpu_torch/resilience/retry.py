"""Transient-I/O retry with jittered exponential backoff.

The port's copy of ``orion_tpu/resilience/retry.py`` (jax-free, stdlib
only), kept in step with it by ``tests/test_torch_load.py``.

Checkpoint and token-bin reads on preemptible fleets fail transiently
(storage blips, NFS hiccups); a one-shot ``open()`` turns a 2-second blip
into a lost run. ``call_with_retries`` retries only the exception types the
policy names (default ``OSError`` — corruption-shaped errors like
``ValueError`` from a decoder must NOT be retried: re-reading corrupt bytes
yields corrupt bytes), backing off exponentially with deterministic jitter.

Everything time-shaped is injectable — ``sleep`` and the jitter ``rng`` —
so the chaos tests assert exact delay sequences with a fake clock and run
in milliseconds.
"""

from __future__ import annotations

import dataclasses
import random
import time
import warnings
import zlib
from typing import Callable, Optional, Tuple, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts = total tries (1 = no retry). Delay before retry i (1-based)
    is ``min(max_delay, base_delay * 2**(i-1)) * (1 + jitter * u)`` with
    ``u ~ U[0, 1)`` — jitter only ever stretches, so tests can lower-bound
    delays exactly."""

    attempts: int = 4
    base_delay: float = 0.1
    max_delay: float = 5.0
    jitter: float = 0.5
    retry_on: Tuple[type, ...] = (OSError,)


def call_with_retries(
    fn: Callable[[], T],
    policy: RetryPolicy = RetryPolicy(),
    *,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    describe: str = "operation",
    should_abort: Optional[Callable[[], bool]] = None,
) -> T:
    """Run ``fn`` under ``policy``. Non-retryable exceptions propagate
    immediately; the last retryable one propagates after the budget is
    spent. The jitter rng defaults to a seed derived from ``describe`` so a
    given call site backs off identically run to run (determinism is the
    whole point of this subsystem).

    ``should_abort``: polled after each retryable failure, BEFORE the
    backoff sleep. When it returns True the pending exception propagates
    immediately instead of burning the remaining retry budget — the
    serving layer plumbs its health machine in here so a DRAINING/DEAD
    server doesn't spend its SIGTERM grace period backing off on session
    or checkpoint I/O nobody will wait for. The first attempt always
    runs; aborting only cancels retries."""
    if rng is None:
        rng = random.Random(zlib.crc32(describe.encode()))
    for attempt in range(1, max(policy.attempts, 1) + 1):
        try:
            return fn()
        except policy.retry_on as e:
            if attempt >= policy.attempts:
                raise
            if should_abort is not None and should_abort():
                warnings.warn(
                    f"{describe} failed (attempt {attempt}/{policy.attempts}: "
                    f"{type(e).__name__}: {e}); aborting retries "
                    "(should_abort)",
                    stacklevel=2,
                )
                raise
            delay = min(
                policy.max_delay, policy.base_delay * (2 ** (attempt - 1))
            )
            delay *= 1.0 + policy.jitter * rng.random()
            warnings.warn(
                f"{describe} failed (attempt {attempt}/{policy.attempts}: "
                f"{type(e).__name__}: {e}); retrying in {delay:.3f}s",
                stacklevel=2,
            )
            sleep(delay)
    raise AssertionError("unreachable: attempts >= 1 always returns/raises")


def retrying(policy: RetryPolicy = RetryPolicy(), **kw):
    """Decorator form of :func:`call_with_retries`."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **k):
            return call_with_retries(
                lambda: fn(*a, **k), policy,
                describe=kw.get("describe", fn.__qualname__),
                sleep=kw.get("sleep", time.sleep),
                rng=kw.get("rng"),
                should_abort=kw.get("should_abort"),
            )

        return wrapped

    return deco


__all__ = ["RetryPolicy", "call_with_retries", "retrying"]
