"""The schedule the closed loop implies, worked out from the traffic
alone: the engine's slot and step bookkeeping is judged against it.

Client c's first request goes to slot c at step 0.  A request admitted at
step a with n output tokens gives its first token at prefill, one more in
each decode wave from a on, finishes at the end of wave a + n - 2 (the
engine's step counter then reads a + n - 1) and frees its slot; the
client's next request enters the same slot at step a + n - 1 (clients
whose requests finish on one step submit in slot order, and FIFO
admission fills free slots in that order).  Requests still in flight
after the last wave are closed with the tokens they have: 1 + (waves -
a)."""
from __future__ import annotations

import heapq


def simulate(traffic, n_waves: int) -> dict:
    """{request id: (slot, admitted_step, finished_step, tokens, shed)}
    for every request submitted while ``n_waves`` decode waves ran.
    Request ids follow submission order: by finishing step, then slot."""
    out = {}
    heap = []                       # (finishing step, slot, id, admitted)
    for slot in range(traffic.clients):
        heapq.heappush(heap, (traffic.item(slot).max_new_tokens - 1, slot,
                              slot, 0))
    k = traffic.clients
    while heap:
        fin, slot, rid, adm = heapq.heappop(heap)
        if fin > n_waves:
            out[rid] = (slot, adm, n_waves, 1 + n_waves - adm, True)
            continue
        out[rid] = (slot, adm, fin, traffic.item(rid).max_new_tokens, False)
        if fin < n_waves:
            heapq.heappush(heap, (fin + traffic.item(k).max_new_tokens - 1,
                                  slot, k, fin))
            k += 1
    return out
