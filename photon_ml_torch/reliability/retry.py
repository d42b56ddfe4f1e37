"""Bounded exponential-backoff retry for transient I/O.

Counterpart of ``photon_ml_tpu/reliability/retry.py``: only OSErrors
whose errno is in ``TRANSIENT_ERRNOS`` retry; capacity, permission,
existence and corruption errors propagate at once.  The backoff is
deterministic (no jitter).  Retries are logged and counted
(``store.retries`` every retried attempt, ``store.gave_up`` every
exhausted budget), and each backoff is an ``io-retry`` heartbeat, so a
wait reads as deliberate, not as a hang.
"""

from __future__ import annotations

import errno
import logging
import time

from photon_ml_torch import telemetry

logger = logging.getLogger(__name__)

IO_ATTEMPTS = 3
IO_BASE_DELAY_S = 0.05
IO_MAX_DELAY_S = 2.0

TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EINTR, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT,
    errno.ENFILE, errno.EMFILE, errno.ESTALE,
})


def is_transient(e: BaseException) -> bool:
    return isinstance(e, OSError) and e.errno in TRANSIENT_ERRNOS


def run_with_retries(fn, label: str, attempts: int = IO_ATTEMPTS,
                     base_delay_s: float = IO_BASE_DELAY_S,
                     max_delay_s: float = IO_MAX_DELAY_S,
                     retriable=is_transient,
                     retry_counter: str = "store.retries",
                     gave_up_counter: str = "store.gave_up"):
    """Run ``fn()`` with up to ``attempts`` tries; non-retriable errors
    and the last retriable one (counted ``gave_up_counter``) propagate.
    Backoff doubles, capped."""
    attempts = max(1, int(attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as e:
            if not retriable(e):
                raise
            if attempt == attempts - 1:
                telemetry.count(gave_up_counter)
                logger.warning("%s: giving up after %d attempts (%r)",
                               label, attempts, e)
                raise
            delay = min(base_delay_s * (2.0 ** attempt), max_delay_s)
            telemetry.count(retry_counter)
            telemetry.heartbeat("io-retry", label=label,
                                attempt=attempt + 1,
                                delay_s=round(delay, 3), error=repr(e))
            logger.warning("%s: attempt %d/%d failed (%r); retrying in "
                           "%.3fs", label, attempt + 1, attempts, e, delay)
            time.sleep(delay)
