"""The port's data stream (``repro_torch/runtime/data.py``): the
reference's determinism, resume, host-partition, shape and eval cases on
the port's own stream, and the stream's statistics (the echo share, the
EOS layout) against the reference's.  The two streams draw other numbers
(``torch.Generator`` vs ``jax.random``), so they agree in distribution,
not bit for bit."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.runtime import data as ref  # noqa: E402
from repro_torch.runtime.data import (DataConfig, DataPipeline,  # noqa: E402
                                      eval_batches)

CFG = DataConfig(vocab=256, seq_len=64, global_batch=4, seed=1)


def test_data_deterministic_and_resumable():
    p1 = DataPipeline(CFG)
    b0, b1, b2 = next(p1), next(p1), next(p1)
    assert p1.state() == {"seed": 1, "next_step": 3}
    p2 = DataPipeline.from_state(CFG, {"seed": 1, "next_step": 1})
    r1, r2 = next(p2), next(p2)
    for k in ("tokens", "labels", "mask"):
        assert torch.equal(b1[k], r1[k]) and torch.equal(b2[k], r2[k])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    # a pure function of (seed, step, host): a fresh pipeline agrees
    assert torch.equal(DataPipeline(CFG).batch_at(2)["tokens"],
                       b2["tokens"])
    with pytest.raises(ValueError, match="seed changed"):
        DataPipeline.from_state(CFG, {"seed": 2, "next_step": 0})


def test_data_host_sharding_partitions_global_batch():
    full = DataPipeline(CFG).batch_at(0)
    half0 = DataPipeline(dataclasses.replace(
        CFG, n_hosts=2, host_id=0)).batch_at(0)
    half1 = DataPipeline(dataclasses.replace(
        CFG, n_hosts=2, host_id=1)).batch_at(0)
    assert half0["tokens"].shape == (2, 64) and full["tokens"].shape == (4, 64)
    assert not torch.equal(half0["tokens"], half1["tokens"])
    with pytest.raises(ValueError, match="split"):
        DataPipeline(dataclasses.replace(CFG, n_hosts=3)).batch_at(0)


def test_data_shapes_and_ranges():
    b = DataPipeline(CFG).batch_at(3)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 256
    assert b["mask"].shape == (4, 64)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])
    assert float(b["mask"][:, :-1].min()) == 1.0
    assert float(b["mask"][:, -1].max()) == 0.0


def test_eval_batches_disjoint_from_train():
    tr = DataPipeline(CFG).batch_at(0)
    ev = eval_batches(CFG, 2)
    assert len(ev) == 2 and not torch.equal(tr["tokens"], ev[0]["tokens"])
    shifted = DataPipeline(dataclasses.replace(CFG, seed=CFG.seed + 10_000))
    assert torch.equal(ev[1]["tokens"], shifted.batch_at(1)["tokens"])


def _doc_lens(toks: np.ndarray, eos: int) -> list:
    """Each row's document length d in [64, 512): the one whose EOS grid
    (positions with pos % d == d - 1) holds only EOS; None where no d
    fits."""
    s = toks.shape[1]
    out = []
    for row in toks:
        fits = [d for d in range(64, 512)
                if all(row[p] == eos for p in range(d - 1, s, d))]
        out.append(fits[0] if fits else None)
    return out


def _stats(toks: np.ndarray, v: int, eos: int) -> dict:
    """The echo share (positions >= 2 whose token is the one two back + 1,
    EOS excluded) and the EOS share."""
    echo = (toks[:, 2:] == (toks[:, :-2] + 1) % v) & (toks[:, 2:] != eos)
    return {"echo": float(echo.mean()), "eos": float((toks == eos).mean())}


def test_stream_statistics_agree_with_the_reference():
    cfg = DataConfig(vocab=1000, seq_len=1024, global_batch=64, seed=3)
    rcfg = ref.DataConfig(vocab=1000, seq_len=1024, global_batch=64, seed=3)
    got = np.concatenate([DataPipeline(cfg).batch_at(i)["tokens"].numpy()
                          for i in range(2)])
    want = np.concatenate([np.asarray(ref.DataPipeline(rcfg).batch_at(i)
                                      ["tokens"]) for i in range(2)])
    # tokens from min(vocab, 512) ids, the echo's + 1 taken mod 512
    assert got.max() < 512 and want.max() < 512
    g, w = _stats(got, 512, 1), _stats(want, 512, 1)
    # the echo repeats the order-1 draw two back, so the sequence shows it
    # where t is echoed and t - 2 is not: ~0.5 x 0.5.  128 rows x 1022
    # positions: binomial sigma ~0.0014
    assert abs(g["echo"] - w["echo"]) < 0.01, (g, w)
    assert 0.23 < g["echo"] < 0.27
    # every row is packed on one EOS grid with d in [64, 512)
    dg, dw = _doc_lens(got, 1), _doc_lens(want, 1)
    assert None not in dg and None not in dw
    # d uniform on [64, 512): mean 287.5, sigma of a 128-row mean ~11.4
    assert abs(np.mean(dg) - 287.5) < 50 and abs(np.mean(dw) - 287.5) < 50
    assert abs(g["eos"] - w["eos"]) < 0.002, (g, w)
