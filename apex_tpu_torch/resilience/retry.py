"""Deadline-aware exponential backoff with jitter.

Counterpart of ``apex_tpu/resilience/retry.py``, host Python copied as
is: one retry policy for every edge that can transiently fail (the fleet
router's engine steps, its snapshot saves and its KV handoff wire).

- **deadline-aware**: ``deadline`` bounds the total time spent
  (attempts + sleeps) from the first call; the last sleep is clamped to
  the remaining budget.
- **jitter**: each delay is scaled by a factor drawn from
  ``[1-jitter, 1+jitter]`` from an injectable ``random.Random`` (tests
  pass a seeded one, or ``jitter=0``).
- **injectable clock/sleep**: ``sleep`` and ``monotonic`` are
  parameters.
- **non-retryable allowlist**: exceptions in ``give_up_on`` (plus
  :data:`NON_RETRYABLE`) re-raise from the first attempt even when they
  match ``retry_on`` — the fleet router puts ``faults.EngineCrash``
  there, so a dead engine is fenced at once, never retried.
- **named sites**: ``site="..."`` publishes every retry sleep as
  ``retry_attempts{site=}`` plus a ``retry`` event, and the terminal
  outcomes as ``retry_exhausted{site=}`` / ``retry_give_up{site=}``, on
  the process-default registry, best-effort. Without ``site`` the call
  publishes nothing.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

_RNG = random.Random()

# Never retried, whatever retry_on says: retrying cannot change the
# outcome (deterministic failures) or actively fights the user/runtime
# (interrupts, shutdown). Extended per call via ``give_up_on``.
NON_RETRYABLE: Tuple[Type[BaseException], ...] = (
    KeyboardInterrupt, SystemExit)


def _note_retry(site: str, attempt: int, exc: BaseException,
                delay: float) -> None:
    """One retry sleep at a named site: counter + flight-ring event.
    Best-effort — telemetry must never fail the retried call."""
    try:
        from apex_tpu_torch.telemetry import metrics as _metrics

        reg = _metrics.registry()
        reg.counter("retry_attempts",
                    "retry_call sleeps (re-attempts) by site").inc(
                        site=site)
        reg.event("retry", site=site, attempt=int(attempt),
                  delay_s=round(float(delay), 6),
                  error=f"{type(exc).__name__}: {exc}")
    except Exception:  # noqa: BLE001 — observability is best-effort
        pass


def _note_terminal(site: str, outcome: str, exc: BaseException) -> None:
    """A retry loop's terminal failure at a named site: ``outcome`` is
    ``"exhausted"`` (budget burned) or ``"give_up"`` (non-retryable
    pass-through). Best-effort, like :func:`_note_retry`."""
    try:
        from apex_tpu_torch.telemetry import metrics as _metrics

        reg = _metrics.registry()
        reg.counter(f"retry_{outcome}",
                    f"retry_call {outcome} terminal failures by "
                    "site").inc(site=site)
        reg.event(f"retry_{outcome}", site=site,
                  error=f"{type(exc).__name__}: {exc}")
    except Exception:  # noqa: BLE001 — observability is best-effort
        pass


def backoff_delays(retries: int, *, base_delay: float = 0.05,
                   factor: float = 2.0, max_delay: float = 2.0,
                   jitter: float = 0.5, rng: Optional[random.Random] = None):
    """The delay schedule ``retry_call`` sleeps through, as a list —
    exposed so tests (and capacity planning) can inspect the exact
    schedule a policy produces."""
    rng = rng if rng is not None else _RNG
    out = []
    for i in range(retries):
        d = min(max_delay, base_delay * (factor ** i))
        if jitter:
            d *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        out.append(max(0.0, d))
    return out


def retry_call(
    fn: Callable,
    *args,
    retries: int = 4,
    base_delay: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    deadline: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    monotonic: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    site: Optional[str] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` exceptions up
    to ``retries`` times (``retries + 1`` attempts total) with
    exponential backoff, jitter, and an optional total ``deadline`` in
    seconds. The last exception is re-raised unchanged when the budget
    is exhausted (callers keep catching the original type).
    ``on_retry(attempt, exc, delay)`` fires before each sleep.

    ``give_up_on`` exceptions (always including :data:`NON_RETRYABLE`)
    re-raise from the FIRST attempt even when they also match
    ``retry_on`` — the escape hatch for deterministic failures dressed
    as I/O errors (e.g. a ``CheckpointError`` raised on validation:
    the same bytes fail the same way on every retry).

    ``site`` names the call site for telemetry (module docstring):
    ``retry_attempts{site=}`` per sleep plus a ``retry`` event, and
    ``retry_exhausted{site=}`` / ``retry_give_up{site=}`` on terminal
    failure. ``None`` (the default) publishes nothing."""
    rng = rng if rng is not None else _RNG
    no_retry = NON_RETRYABLE + tuple(give_up_on)
    start = monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if isinstance(e, no_retry):
                if site is not None:
                    _note_terminal(site, "give_up", e)
                raise
            if attempt >= retries:
                if site is not None:
                    _note_terminal(site, "exhausted", e)
                raise
            delay = min(max_delay, base_delay * (factor ** attempt))
            if jitter:
                delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
            delay = max(0.0, delay)
            if deadline is not None:
                remaining = deadline - (monotonic() - start)
                if remaining <= 0:
                    if site is not None:
                        _note_terminal(site, "exhausted", e)
                    raise
                delay = min(delay, remaining)
            if site is not None:
                _note_retry(site, attempt, e, delay)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            attempt += 1


def retry(**policy):
    """Decorator form of :func:`retry_call`::

        @retry(retries=3, deadline=2.0)
        def flaky_io(...): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, **policy, **kwargs)
        return wrapped
    return deco


__all__ = ["NON_RETRYABLE", "backoff_delays", "retry", "retry_call"]
