"""Fair-share worker-lease scheduling for the multi-tenant service.

The engine owns one bounded worker pool; every active run *requests* up
to its spec's ``n_workers``.  ``fair_shares`` splits the pool by
round-robin grant — one worker per run per round, submission order,
capped at each run's request — so the allocation is max-min fair:

* pool >= sum(requests): everyone gets what they asked for;
* pool < sum(requests): shares differ by at most one worker (earlier
  submissions win the remainder), and no run is starved while another
  holds more than its fair share;
* more runs than workers: the first ``total`` runs get one worker each,
  the rest wait at lease 0 until a slot frees (the engine re-computes
  leases every poll, so completion of any run immediately promotes the
  starved ones).

Pure function of (pool size, ordered requests) — deterministic, trivially
testable, and the single place the service's fairness claim lives.
"""
from __future__ import annotations


def fair_shares(total: int, requests: dict[str, int]) -> dict[str, int]:
    """Max-min fair split of ``total`` workers over ordered requests.

    ``requests`` maps run id -> wanted workers (insertion order is the
    priority order for remainders).  Returns run id -> granted lease;
    grants sum to ``min(total, sum(requests))``.
    """
    shares = {rid: 0 for rid in requests}
    remaining = max(0, int(total))
    while remaining > 0:
        granted = False
        for rid, want in requests.items():
            if remaining == 0:
                break
            if shares[rid] < max(0, int(want)):
                shares[rid] += 1
                remaining -= 1
                granted = True
        if not granted:          # every request satisfied; pool has slack
            break
    return shares
