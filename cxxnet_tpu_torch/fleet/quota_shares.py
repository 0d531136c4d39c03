"""Distributed tenant quotas: fleet rate split into per-door shares
(counterpart of ``cxxnet_tpu/fleet/quota_shares.py``).

With N balancer processes fronting one fleet, a single in-process
:class:`~cxxnet_tpu_torch.serve.quota.QuotaManager` would multiply every
tenant's contract by N. Instead each door runs a
:class:`QuotaShareManager` enforcing a *fraction* of the fleet policy,
and the fractions rebalance periodically toward observed per-door
demand: a tenant bursting through one door borrows unused share from
idle doors, while the sum of shares never exceeds 1.

Invariants (property-tested in tests/test_fleet_front_tier.py):

- **Never over fleet rate by more than one rebalance window.** With
  consistent demand views the per-tenant share fractions sum to
  exactly 1, so the summed refill rates equal the fleet rate; burst
  capacity is split the same way. Views are exchanged over gossip, so
  doors transiently disagree — and the dangerous disagreement is
  everyone raising at once (a fleet-wide demand ramp is seen
  own-fresh, peers-stale at every door). Hence the asymmetric rule:
  share *cuts* apply immediately, share *raises* are deferred one
  rebalance round — a door may only grow past its applied share after
  its demand has had a full round to reach the peers cutting theirs.
  A demand shift can then over-admit only within the staleness of one
  gossip/rebalance window — after which shares have converged again.
- **A single-door fleet is bit-identical to ``QuotaManager``.** At
  ``balancers=1`` the share fraction is exactly ``1.0``; bucket
  parameters are ``rate * 1.0`` / ``burst * 1.0`` (IEEE-exact), and
  rebalancing is a no-op (``reconfigure`` returns before touching
  bucket state when parameters are unchanged).

Share formula (:func:`compute_shares`): a floor of
``floor_total / n`` per door (so an idle door keeps a trickle for
newly arriving traffic and never deadlocks a tenant), the remainder
proportional to each door's observed demand rate. Deterministic: every
door computes the same fractions from the same merged views.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from ..serve.quota import QuotaManager, TokenBucket

# fraction of the fleet rate reserved as a uniform floor across doors;
# the other 90% follows demand
FLOOR_TOTAL = 0.1


def compute_shares(demand: Dict[str, float], balancers: int,
                   floor_total: float = FLOOR_TOTAL
                   ) -> Dict[str, float]:
    """Per-door share fractions for one tenant from per-door demand
    rates (rows/s). ``balancers`` is the configured tier width — it
    sets the floor even when some doors' views are missing (a missing
    door keeps enforcing its last-known share locally, so handing its
    slice to others could transiently exceed the fleet rate).

    Guarantees: fractions over the doors present sum to <= 1 (== 1
    when all ``balancers`` doors are present), every present door gets
    >= ``floor_total / balancers``, and ``balancers == 1`` returns
    exactly 1.0."""
    ids = sorted(demand)
    if balancers <= 1:
        return {b: 1.0 for b in ids}
    f0 = floor_total / balancers
    total = sum(max(0.0, r) for r in demand.values())
    if total <= 0.0:
        return {b: 1.0 / balancers for b in ids}
    scale = 1.0 - f0 * balancers
    return {b: f0 + scale * max(0.0, demand[b]) / total for b in ids}


class QuotaShareManager(QuotaManager):
    """A :class:`QuotaManager` whose buckets enforce this door's share
    of the fleet policy.

    Demand accounting rides :meth:`admit` (requested rows, admitted or
    shed — shed demand is exactly the signal that this door needs more
    share). :meth:`sample_demand` converts the window to rates for the
    gossip view; :meth:`rebalance` applies merged views from every
    door and retunes live buckets in place."""

    def __init__(self, cfg: Sequence = (), balancer_id: str = "b0",
                 balancers: int = 1):
        super().__init__(cfg)
        self.balancer_id = balancer_id
        self.balancers = max(1, int(balancers))
        self._fracs: Dict[str, float] = {}
        # raw computed fracs from the previous rebalance round: the
        # cap on this round's raises (cuts bypass it)
        self._computed: Dict[str, float] = {}
        self._demand: Dict[str, float] = {}
        self._demand_t0 = time.monotonic()
        self._demand_rates: Dict[str, float] = {}
        self.rebalances = 0

    # -- share math -------------------------------------------------------

    def _frac_for(self, tenant: str) -> float:
        return self._fracs.get(tenant, 1.0 / self.balancers)

    @staticmethod
    def _scaled_burst(burst: float, frac: float) -> float:
        # a door's burst slice must still admit a minimal request, or
        # a tenant could be starved forever at a near-floor share
        return max(burst * frac, min(burst, 1.0))

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        policy = self.policy_for(tenant)
        if policy is None:
            return None
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = policy
                frac = self._frac_for(tenant)
                b = TokenBucket(rate * frac,
                                self._scaled_burst(burst, frac))
                self._buckets[tenant] = b
            return b

    # -- demand accounting ------------------------------------------------

    def admit(self, tenant: str, rows: int) -> None:
        with self._lock:
            self._demand[tenant] = \
                self._demand.get(tenant, 0.0) + float(rows)
        super().admit(tenant, rows)

    def sample_demand(self) -> Dict[str, float]:
        """Close the demand window: per-tenant requested rows/s since
        the previous sample. The result is also cached for
        :meth:`demand_view` (the gossip endpoint must be
        non-destructive — N-1 peers fetch it per period)."""
        now = time.monotonic()
        with self._lock:
            window, self._demand = self._demand, {}
            t0, self._demand_t0 = self._demand_t0, now
            dt = max(1e-6, now - t0)
            self._demand_rates = \
                {t: r / dt for t, r in window.items()}
            return dict(self._demand_rates)

    def demand_view(self) -> Dict[str, float]:
        """Last sampled demand rates (non-destructive)."""
        with self._lock:
            return dict(self._demand_rates)

    # -- rebalance --------------------------------------------------------

    def rebalance(self, views: Dict[str, Dict[str, float]]
                  ) -> Dict[str, float]:
        """Recompute this door's share per tenant from the merged
        per-door demand views ``{balancer_id: {tenant: rows/s}}``
        (must include this door's own view) and retune live buckets.
        Returns the changed ``{tenant: frac}``. Pure share math is
        :func:`compute_shares` — deterministic, so every door derives
        consistent fractions from consistent views.

        Raises are deferred one round (see the module invariant): a
        computed frac above the applied one takes effect only if the
        previous round computed at least as much — by then this
        door's demand has been gossiped and the doors losing share
        have already cut (cuts apply immediately)."""
        tenants = set()
        for view in views.values():
            tenants.update(view)
        with self._lock:
            tenants.update(self._buckets)
            tenants.update(self._fracs)
        changed: Dict[str, float] = {}
        for tenant in sorted(tenants):
            demand = {b: float(views[b].get(tenant, 0.0))
                      for b in views}
            demand.setdefault(self.balancer_id, 0.0)
            fracs = compute_shares(demand, self.balancers)
            computed = fracs.get(self.balancer_id,
                                 1.0 / self.balancers)
            with self._lock:
                prev = self._frac_for(tenant)
                if computed > prev:
                    cap = self._computed.get(tenant, prev)
                    frac = max(prev, min(computed, cap))
                else:
                    frac = computed
                self._computed[tenant] = computed
                self._fracs[tenant] = frac
                bucket = self._buckets.get(tenant)
            if frac != prev:
                changed[tenant] = frac
            policy = self.policy_for(tenant)
            if bucket is not None and policy is not None:
                rate, burst = policy
                bucket.reconfigure(rate * frac,
                                   self._scaled_burst(burst, frac))
        self.rebalances += 1
        return changed

    def share_snapshot(self) -> Dict[str, object]:
        """For /healthz: the door's current share fractions."""
        with self._lock:
            fracs = {t: round(f, 4)
                     for t, f in sorted(self._fracs.items())}
        return {"balancers": self.balancers,
                "fracs": fracs, "rebalances": self.rebalances}
