"""Per-client admission quotas for the correction service (counterpart
of quorum_tpu/serve/admission.py, the whole module).

Overload in the batcher is FIFO-shaped: the bounded queue sheds at
the door (429) but does not care WHO filled it, so one bulk client
saturating `--queue-requests` starves every interactive one. The
quota layer makes overload degrade by policy instead of queue order:
each client (the `X-Quorum-Client` request header) gets a standard
token bucket — `--quota-rps` tokens per second refill, `--quota-burst`
capacity — and a request that finds its bucket empty answers 429 with
a Retry-After derived from the actual refill time, before it ever
touches the shared queue.

Quotas are per *declared identity*: a request without the
`X-Quorum-Client` header is not quota-limited (there is no principal
to charge; the bounded queue still backstops it). A fleet fronted by
a load balancer stamps the header; abusive anonymous traffic is an
edge concern for the LB, not the correction engine.

The clock is injectable so tests drive refill deterministically.
"""

from __future__ import annotations

import threading
import time


class TokenBucketQuota:
    """One token bucket per client id, created on first sight.

    `admit(client)` costs one token. Buckets refill continuously at
    `rate_per_s` up to `burst`. The table is an LRU bounded at
    `max_clients`: every admit moves the client to the tail (dicts
    are insertion-ordered) and evicts from the head in O(1) — an
    evicted mid-drain client re-enters with a fresh bucket, trading a
    sliver of quota grace under an id flood for never scanning the
    table on the hot admission path.
    """

    def __init__(self, rate_per_s: float, burst: float | None = None,
                 max_clients: int = 10000, clock=time.monotonic):
        if rate_per_s <= 0:
            raise ValueError("quota rate must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst else max(1.0, self.rate)
        if self.burst < 1.0:
            raise ValueError("quota burst must be >= 1")
        self.max_clients = int(max_clients)
        self.clock = clock
        self._lock = threading.Lock()
        # client -> (tokens, last_refill); LRU order = dict order
        self._buckets: dict[str, tuple[float, float]] = {}

    def admit(self, client: str) -> tuple[bool, float]:
        """Charge one token to `client`. Returns (admitted,
        retry_after_s) — retry_after_s is 0 when admitted, else the
        time until the bucket holds a full token again."""
        now = self.clock()
        with self._lock:
            entry = self._buckets.pop(client, None)
            tokens, last = entry if entry else (self.burst, now)
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            admitted = tokens >= 1.0
            if admitted:
                tokens -= 1.0
            self._buckets[client] = (tokens, now)  # LRU tail
            while len(self._buckets) > self.max_clients:
                self._buckets.pop(next(iter(self._buckets)))
            if admitted:
                return True, 0.0
            return False, (1.0 - tokens) / self.rate

    @property
    def clients(self) -> int:
        with self._lock:
            return len(self._buckets)
