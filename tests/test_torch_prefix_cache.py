"""The port's ``PrefixCache`` and ``Heartbeat`` against the JAX package's.

Both caches see the same operation sequence on the same numpy tokens and
KV trees of the same shapes: lookups, probes and every counter (hits,
misses, entries, bytes, inserts, evictions, invalidations) are held
exactly equal.  Heartbeat files written by either package are read by
both, key for key.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.runtime import prefix_cache as j_pc  # noqa: E402
from repro.runtime.watchdog import Heartbeat as JHeartbeat  # noqa: E402
from repro_torch.runtime import prefix_cache as pc_mod  # noqa: E402
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime.watchdog import Heartbeat  # noqa: E402


def _kv(n, layers=2, heads=2, dim=4):
    shape = (layers, 1, n, heads, dim)
    t = {"layers_0_dense": {"k": torch.zeros(shape, dtype=torch.bfloat16),
                            "v": torch.zeros(shape, dtype=torch.bfloat16)}}
    j = {"layers_0_dense": {"k": jnp.zeros(shape, jnp.bfloat16),
                            "v": jnp.zeros(shape, jnp.bfloat16)}}
    return t, j


def _both(**kw):
    return PrefixCache(**kw), j_pc.PrefixCache(**kw)


def _insert(caches, version, tokens, logits=None):
    t, j = _kv(len(tokens))
    got = caches[0].insert(version, tokens, t,
                           None if logits is None else torch.tensor(logits))
    want = caches[1].insert(version, tokens, j,
                            None if logits is None else np.asarray(logits))
    assert got == want
    return got


def _lookup(caches, version, tokens, lengths):
    a = caches[0].lookup(version, tokens, lengths)
    b = caches[1].lookup(version, tokens, lengths)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.n_tokens == b.n_tokens
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.logits is None) == (b.logits is None)
    return a


def _same_stats(caches):
    assert caches[0].stats() == caches[1].stats()
    assert len(caches[0]) == len(caches[1])


def test_sequence_of_operations_matches_reference():
    rng = np.random.default_rng(0)
    caches = _both(capacity=4)
    prompts = [rng.integers(0, 1000, n).astype(np.int32)
               for n in (12, 9, 3, 16, 8)]
    for i, p in enumerate(prompts):
        _insert(caches, 0, p, [float(i)] * 5)
        _insert(caches, 0, p[:8], None)          # a chunk-aligned prefix
        _same_stats(caches)
    assert caches[0].stats()["evictions"] > 0
    for p in prompts + [prompts[0][:4], prompts[3][:11]]:
        for lengths in ([len(p)], [len(p), 8, 4]):
            _lookup(caches, 0, p, lengths)
            assert caches[0].probe(0, p, lengths) == \
                caches[1].probe(0, p, lengths)
            _same_stats(caches)
    _lookup(caches, 1, prompts[4], [8])          # another params version
    _same_stats(caches)
    assert caches[0].invalidate() == caches[1].invalidate()
    _same_stats(caches)
    assert caches[0].invalidate() == caches[1].invalidate() == 0


def test_min_tokens_and_byte_budget():
    caches = _both(capacity=8, min_tokens=5, max_bytes=3 * 8 * 16 * 2 * 2)
    assert not _insert(caches, 0, np.arange(4, dtype=np.int32))
    for n in (8, 8, 8, 8):
        _insert(caches, 0, np.arange(n, dtype=np.int32) + 100 * len(
            caches[0]))
        _same_stats(caches)
    st = caches[0].stats()
    assert st["entries"] == 3 and st["evictions"] == 1
    assert st["bytes"] == 3 * 2 * 2 * 8 * 2 * 4 * 2


def test_probe_leaves_counters_and_recency():
    c = PrefixCache(capacity=2)
    a, b = np.arange(6, dtype=np.int32), np.arange(6, 12, dtype=np.int32)
    c.insert(0, a, _kv(6)[0])
    c.insert(0, b, _kv(6)[0])
    before = c.stats()
    assert c.probe(0, a, [6]) == 6 and c.stats() == before
    c.insert(0, np.arange(20, 26, dtype=np.int32), _kv(6)[0])
    assert c.probe(0, a, [6]) == 0            # a was least recent
    assert c.lookup(0, b, [6]) is not None


def test_hash_collision_fails_closed(monkeypatch):
    """Every key collides: a lookup verifies the stored tokens and misses."""
    monkeypatch.setattr(pc_mod, "_token_key", lambda tokens: "same")
    c = PrefixCache()
    a, b = np.arange(6, dtype=np.int32), np.arange(1, 7, dtype=np.int32)
    c.insert(0, a, _kv(6)[0])
    assert c.lookup(0, b, [6]) is None and c.stats()["misses"] == 1
    assert c.lookup(0, a, [6]) is not None


def test_longer_query_prefix_and_short_query():
    c = PrefixCache()
    p = np.arange(12, dtype=np.int32)
    c.insert(0, p[:8], _kv(8)[0])
    assert c.lookup(0, p, [12, 8, 4]).n_tokens == 8
    assert c.lookup(0, p[:6], [6, 4]) is None     # 8 > 6: never served


def test_capacity_must_be_positive():
    with pytest.raises(ValueError):
        PrefixCache(capacity=0)


def test_heartbeats_cross_read(tmp_path):
    """Either package reads the other's beats; stale hosts are named."""
    mine = Heartbeat(tmp_path, host_id=0)
    theirs = JHeartbeat(tmp_path, host_id=1)
    assert mine.path.name == "heartbeat_0.json"
    mine.beat(3, active=2, completed=5)
    mine.beat(4, active=1, completed=6)
    theirs.beat(7, active=0)
    for reader in (Heartbeat, JHeartbeat):
        beats = reader.read_all(tmp_path)
        assert [b["host"] for b in beats] == [0, 1]
        assert beats[0] == dict(beats[0], host=0, step=4, count=2, active=1,
                                completed=6)
        assert beats[1]["step"] == 7 and beats[1]["count"] == 1
        assert sorted(beats[0]) == sorted(
            json.loads(theirs.path.read_text()) | {"completed": 0})
    assert not list(tmp_path.glob("*.tmp-*"))
    old = json.loads(mine.path.read_text())
    old["time"] = time.time() - 1000
    mine.path.write_text(json.dumps(old))
    assert Heartbeat.stale_hosts(tmp_path, timeout_s=120) == \
        JHeartbeat.stale_hosts(tmp_path, timeout_s=120) == [0]
    (tmp_path / "heartbeat_9.json").write_text("{torn")
    assert len(Heartbeat.read_all(tmp_path)) == 2
    assert os.path.exists(mine.path)


def test_engine_beats_after_every_working_step(tmp_path):
    from repro_torch.configs import get
    from repro_torch.models.params import init_params
    from repro_torch.runtime.engine import Request, ServingEngine
    model = get("gemma-7b").make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    hb = Heartbeat(tmp_path, host_id=3)
    eng = ServingEngine(model, params, max_len=16, batch_size=2,
                        chunk_prefill=4, heartbeat=hb)
    eng.run([Request(i, np.arange(5 + i, dtype=np.int32), 3)
             for i in range(3)])
    [beat] = JHeartbeat.read_all(tmp_path)
    rep = eng.scheduler_report()
    assert beat["host"] == 3 and beat["step"] == rep["steps"]
    assert beat["completed"] == 3 and beat["active"] == 0
    assert beat["count"] >= rep["steps"] + 1     # chunk-only steps beat too
