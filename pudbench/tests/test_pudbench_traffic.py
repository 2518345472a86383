"""The traffic generator and the schedule the closed loop implies."""
import json
import math
import pathlib
import statistics

import numpy as np
import pytest

from pudbench.harness import schedule
from pudbench.harness.traffic import Traffic

MIXES = pathlib.Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["rag", "longdoc"])
def test_deterministic_per_seed(name):
    a, b = Traffic(_mix(name), 1000, 2**31 + 9), Traffic(_mix(name), 1000,
                                                         2**31 + 9)
    for k in (0, 5, 63, 64, 700):
        assert a.item(k) == b.item(k)
        assert np.array_equal(a.tokens(k), b.tokens(k))
    # another seed: the same lengths in the same order, other tokens
    c = Traffic(_mix(name), 1000, 2**31 + 10)
    assert all(a.item(k) == c.item(k) for k in range(200))
    assert not np.array_equal(a.tokens(5), c.tokens(5))


@pytest.mark.parametrize("name", ["rag", "longdoc"])
def test_every_pass_over_the_pool_holds_the_same_lengths(name):
    mix = _mix(name)
    pool = mix["pool"]
    k0 = -(-mix["clients"] // pool) * pool     # past the first requests
    t = Traffic(mix, 1000, 2**40 + 3)
    seen = []
    for start in (k0, k0 + pool):
        seen.append((sorted(t.item(k).prompt_len
                            for k in range(start, start + pool)),
                     sorted(t.item(k).max_new_tokens
                            for k in range(start, start + pool))))
    assert seen[0] == seen[1]
    # each pass in another order
    def lengths(start):
        return [(t.item(k).prompt_len, t.item(k).max_new_tokens)
                for k in range(start, start + pool)]
    assert lengths(k0) != lengths(k0 + pool)


@pytest.mark.parametrize("name", ["rag", "longdoc"])
def test_lengths_follow_the_stated_distribution(name):
    mix = dict(_mix(name), pool=512)
    t = Traffic(mix, 1000, 7)
    n = mix["pool"]
    k0 = -(-mix["clients"] // n) * n
    for kind, get in (("prompt", lambda it: it.prompt_len),
                      ("output", lambda it: it.max_new_tokens)):
        spec = mix[kind]
        xs = [get(t.item(k)) for k in range(k0, k0 + n)]
        mult = spec.get("multiple", 1)
        assert min(xs) >= spec["min"] and max(xs) <= spec["max"]
        assert all(x % mult == 0 for x in xs)
        assert abs(statistics.median(xs) - spec["median"]) <= max(
            mult, 0.02 * spec["median"])
        inside = [x for x in xs if spec["min"] < x < spec["max"]]
        logs = np.log(inside)
        # the interquartile range of a lognormal's log is 1.349 sigma
        q1, q3 = np.percentile(np.log(xs), [25, 75])
        assert abs((q3 - q1) / 1.349 - spec["sigma"]) < 0.1 * spec["sigma"]
        assert len(logs) > 0.9 * n
    toks = t.tokens(3)
    assert toks.dtype == np.int32 and toks.min() >= 0 and toks.max() < 1000


def test_first_requests_keep_a_share_of_their_output():
    mix = _mix("rag")
    t = Traffic(mix, 100, 3)
    plain = Traffic(dict(mix, first_output="none"), 100, 3)
    firsts = [t.item(k).max_new_tokens for k in range(mix["clients"])]
    full = [plain.item(k).max_new_tokens for k in range(mix["clients"])]
    assert all(f <= g for f, g in zip(firsts, full))
    assert sum(firsts) < 0.75 * sum(full)
    assert t.item(mix["clients"]) == plain.item(mix["clients"])


def test_schedule_keeps_each_client_in_its_slot():
    mix = dict(_mix("rag"), clients=4)
    t = Traffic(mix, 100, 11)
    n_waves = 300
    sched = schedule.simulate(t, n_waves)
    by_slot = {}
    for k in sorted(sched):
        slot, adm, fin, n, shed = sched[k]
        by_slot.setdefault(slot, []).append((adm, fin, n, shed))
    for slot, rows in by_slot.items():
        rows.sort()
        assert rows[0][0] == 0
        for (a0, f0, n0, s0), (a1, f1, n1, s1) in zip(rows, rows[1:]):
            assert a1 == f0 and not s0
        last = rows[-1]
        assert last[1] == n_waves
        # every wave of every slot is covered by exactly one request
        assert sum(n - 1 for _, _, n, _ in rows) == n_waves
    # ids are submission order: by finishing step, then slot
    subs = sorted((v[1], v[0], k) for k, v in sched.items() if v[1] > 0)
    assert [k for *_, k in subs] == sorted(k for *_, k in subs)
    assert math.isclose(len(sched), len(set(sched)))
