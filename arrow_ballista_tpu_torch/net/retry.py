"""Bounded, deadline-aware RPC retry.

Mirrors arrow_ballista_tpu/net/retry.py.  Every client-side control-plane
call (executor -> scheduler in ``executor/server.py``, scheduler ->
executor in ``scheduler/netservice.py``) goes through
:func:`call_with_retry`: connect and read deadlines from the
``ballista.rpc.*`` config keys, capped jittered exponential backoff, and a
give-up deadline after which :class:`GiveUpError` (a ``ConnectionError``)
surfaces; callers map it onto the retryable failure paths (the executor
marks the scheduler unreachable; a failed launch becomes ``ExecutorLost``).

Only transport errors are retried.  A :class:`wire.RemoteError` means the
server answered; retrying would re-run a handler that may not be
idempotent, so it propagates.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Optional, Tuple

from . import wire
from ..utils.errors import IntegrityError

#: errors worth retrying: the request may never have reached the peer, or
#: (IntegrityError) the response frame arrived corrupted — transport-level
#: damage a re-send usually heals, unlike a RemoteError, where the server
#: answered intelligibly.
TRANSIENT_ERRORS = (ConnectionError, TimeoutError, OSError, IntegrityError)


class GiveUpError(ConnectionError):
    """The give-up deadline elapsed; ``last`` is the final transport error."""

    def __init__(self, message: str, last: Optional[BaseException] = None):
        super().__init__(message)
        self.last = last


@dataclass
class RetryPolicy:
    """Deadlines + capped jittered exponential backoff.

    Defaults mirror the ``ballista.rpc.*`` config-registry defaults; use
    :meth:`from_config` to honour a session's overrides.
    """

    connect_timeout_s: float = 5.0
    read_timeout_s: float = 60.0
    base_backoff_s: float = 0.2
    max_backoff_s: float = 5.0
    give_up_after_s: float = 30.0
    jitter: float = 0.5  # fraction of each backoff randomized away

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        from ..utils.config import (
            RPC_CONNECT_TIMEOUT_S,
            RPC_READ_TIMEOUT_S,
            RPC_RETRY_BASE_S,
            RPC_RETRY_CAP_S,
            RPC_RETRY_DEADLINE_S,
        )

        return cls(
            connect_timeout_s=float(config.get(RPC_CONNECT_TIMEOUT_S)),
            read_timeout_s=float(config.get(RPC_READ_TIMEOUT_S)),
            base_backoff_s=float(config.get(RPC_RETRY_BASE_S)),
            max_backoff_s=float(config.get(RPC_RETRY_CAP_S)),
            give_up_after_s=float(config.get(RPC_RETRY_DEADLINE_S)),
        )

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based): ``base * 2^attempt``
        capped at ``max``, with up to ``jitter`` of it randomized away so
        a restarted scheduler is not hit by every client at once."""
        capped = min(self.max_backoff_s, self.base_backoff_s * (2.0 ** attempt))
        return capped * (1.0 - self.jitter * random.random())


def call_with_retry(host: str, port: int, method: str,
                    payload: Optional[dict] = None, binary: bytes = b"",
                    policy: Optional[RetryPolicy] = None) -> Tuple[dict, bytes]:
    """``wire.call`` with the policy's deadlines and bounded retry."""
    policy = policy or RetryPolicy()
    deadline = time.monotonic() + policy.give_up_after_s
    attempt = 0
    while True:
        try:
            return wire.call(host, port, method, payload, binary,
                             timeout=policy.read_timeout_s,
                             connect_timeout=policy.connect_timeout_s)
        except wire.RemoteError:
            raise  # the server answered; the failure is not transport-level
        except TRANSIENT_ERRORS as e:
            delay = policy.backoff_s(attempt)
            attempt += 1
            if time.monotonic() + delay >= deadline:
                raise GiveUpError(
                    f"{method} to {host}:{port} still failing after "
                    f"{attempt} attempt(s) within "
                    f"{policy.give_up_after_s:.1f}s give-up deadline: {e}",
                    e) from e
            time.sleep(delay)
