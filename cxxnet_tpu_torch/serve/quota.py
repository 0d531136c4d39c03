"""Per-tenant token-bucket quotas: the fleet's load-shedding policy (a
copy of ``cxxnet_tpu/serve/quota.py``, same grammar and semantics).

One overloaded tenant must not queue into everyone else's p99. The
front end (``serve/frontend.py``) runs every request through a
:class:`QuotaManager` *before* it touches the shared dispatcher queue:
an over-quota request is shed immediately with a typed
:class:`TenantQuotaError` (a :class:`~cxxnet_tpu_torch.serve.
batcher.ServeBusyError` subclass, so library callers that already handle busy
replies keep working) — the 429-with-Retry-After of the protocol
layer. Admitted requests then still face the dispatcher's own bounded
queue, so the two shedding layers compose: quota sheds a tenant that
exceeds its contract, backpressure sheds everyone when the device is
the bottleneck.

Config grammar (the reference's doc/serving.md):

- ``serve_quota`` — comma list of ``tenant:rate[:burst]`` entries.
  ``rate`` is rows/second; ``burst`` is the bucket depth in rows
  (default ``max(rate, 1)``). ``rate 0`` exempts that tenant.
- ``serve_quota_default`` — ``rate[:burst]`` applied to tenants with
  no explicit entry (default: unlimited).

A request of more rows than a tenant's ``burst`` can never be
admitted and is shed deterministically — size your bursts at least one
``serve_max_batch``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from .batcher import ServeBusyError


class TenantQuotaError(ServeBusyError):
    """Typed over-quota shed: the tenant exceeded its token bucket.

    Subclasses :class:`ServeBusyError` so every existing busy-handling
    path (closed-loop clients, the protocol layer's 429 mapping) treats
    it as load shedding; carries the quota parameters so the reply can
    say *whose* quota and when to retry."""

    def __init__(self, tenant: str, rows: int, rate: float,
                 burst: float, retry_after_s: float):
        super().__init__(
            "tenant %r over quota: %d rows requested, %.6g rows/s "
            "rate, %.6g burst (retry in %.2fs)"
            % (tenant, rows, rate, burst, retry_after_s))
        self.tenant = tenant
        self.rows = rows
        self.rate = rate
        self.burst = burst
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill up to
    ``burst``; ``try_take(n)`` admits iff n tokens are available now.
    Thread-safe — protocol handler threads admit concurrently."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0:
            raise ValueError("token bucket rate must be > 0")
        if burst <= 0:
            raise ValueError("token bucket burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        # clamp against a backwards clock step: time.monotonic() is
        # contractually monotonic, but a mocked/virtualized clock (or a
        # future caller passing wall time) must never MINT tokens from
        # a negative elapsed interval, and must not drag _t backwards
        # (which would double-mint when the clock recovers)
        elapsed = now - self._t
        if elapsed <= 0:
            return
        self._tokens = min(self.burst,
                           self._tokens + elapsed * self.rate)
        self._t = now

    def try_take(self, n: float) -> Tuple[bool, float]:
        """Admit ``n`` tokens worth of work now. Returns
        ``(admitted, retry_after_s)`` — when shed, ``retry_after_s``
        estimates when ``n`` tokens will next be available (capped at
        the time a full burst takes, for n > burst)."""
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            missing = min(n, self.burst) - self._tokens
            return False, max(0.0, missing / self.rate)

    def available(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            return self._tokens

    def reconfigure(self, rate: float, burst: float) -> None:
        """Retune a live bucket in place (the fleet tier's quota-share
        rebalancer). Accrued tokens are refilled at the OLD rate up to
        now, then clamped to the new burst — a share cut cannot mint
        tokens, and a share raise keeps only what was already banked.
        Unchanged parameters return without touching state (the
        single-door fleet stays bit-identical under rebalancing)."""
        if rate <= 0:
            raise ValueError("token bucket rate must be > 0")
        if burst <= 0:
            raise ValueError("token bucket burst must be > 0")
        now = time.monotonic()
        with self._lock:
            if rate == self.rate and burst == self.burst:
                return
            self._refill(now)
            self.rate = float(rate)
            self.burst = float(burst)
            self._tokens = min(self._tokens, self.burst)


def _parse_bucket_spec(spec: str) -> Optional[Tuple[float, float]]:
    """``rate[:burst]`` -> (rate, burst); rate 0 means unlimited
    (returns None)."""
    parts = [p.strip() for p in spec.split(":")]
    rate = float(parts[0])
    if rate == 0:
        return None
    if rate < 0:
        raise ValueError("quota rate must be >= 0, got %r" % spec)
    burst = float(parts[1]) if len(parts) > 1 and parts[1] \
        else max(rate, 1.0)
    if burst <= 0:
        # fail at config parse, not as a per-request 400 blaming the
        # first client this tenant sends
        raise ValueError("quota burst must be > 0, got %r" % spec)
    return rate, burst


class QuotaManager:
    """Per-tenant admission control from the ``serve_quota`` config.

    ``admit(tenant, rows)`` either returns (recording the admit) or
    raises :class:`TenantQuotaError` (recording the shed). Tenants
    without an explicit entry share the default policy — each such
    tenant still gets its *own* bucket (a burst from tenant A must not
    drain tenant B's default allowance)."""

    def __init__(self, cfg: Sequence = ()):
        self._explicit: Dict[str, Optional[Tuple[float, float]]] = {}
        self._default: Optional[Tuple[float, float]] = None
        for name, val in cfg:
            # a blank value UNSETS the policy: the fleet tier moves
            # quota enforcement to the balancer and spawns replicas
            # with serve_quota= / serve_quota_default= overrides so a
            # conf-file policy is not double-enforced per replica
            if name == "serve_quota":
                if not val.strip():
                    self._explicit = {}
                    continue
                for entry in val.split(","):
                    entry = entry.strip()
                    if not entry:
                        continue
                    tenant, _, spec = entry.partition(":")
                    if not tenant or not spec:
                        raise ValueError(
                            "serve_quota entry %r must be "
                            "tenant:rate[:burst]" % entry)
                    self._explicit[tenant] = _parse_bucket_spec(spec)
            if name == "serve_quota_default":
                self._default = _parse_bucket_spec(val) \
                    if val.strip() else None
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {"admitted": 0, "shed": 0}
        self.shed_by_tenant: Dict[str, int] = {}

    def policy_for(self, tenant: str) -> Optional[Tuple[float, float]]:
        if tenant in self._explicit:
            return self._explicit[tenant]
        return self._default

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        policy = self.policy_for(tenant)
        if policy is None:
            return None
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = TokenBucket(*policy)
                self._buckets[tenant] = b
            return b

    def admit(self, tenant: str, rows: int) -> None:
        """Charge ``rows`` against ``tenant``'s bucket; raises
        :class:`TenantQuotaError` when over quota."""
        bucket = self._bucket_for(tenant)
        if bucket is None:
            with self._lock:
                self.counters["admitted"] += 1
            return
        ok, retry_after = bucket.try_take(rows)
        with self._lock:
            if ok:
                self.counters["admitted"] += 1
            else:
                self.counters["shed"] += 1
                self.shed_by_tenant[tenant] = \
                    self.shed_by_tenant.get(tenant, 0) + 1
        if not ok:
            raise TenantQuotaError(tenant, rows, bucket.rate,
                                   bucket.burst, retry_after)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"admitted": self.counters["admitted"],
                    "shed": self.counters["shed"],
                    "shed_by_tenant": dict(self.shed_by_tenant)}
