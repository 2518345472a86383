"""A run with the timed path broken underneath comes out not correct.

The harness runs a cell at smoke size on the CPU (its look for a chip is
the entry script's, which this skips), every finished request compared,
with one fault planted in the port's decode step for each fault a
serving cell can have: a step that returns its state unchanged, half of
the batch left out (its rows get the other half's output), and a token
altered where it is produced.  The exchange between chips does not exist
in these one-chip cells."""
import copy
import time

import pytest

from pudbench.harness import cell

from ._smoke import OVERRIDES

SEED = 2**31 + 21


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _state_unchanged(orig):
    def step(self, params, cache, tokens, cur_len=None):
        logits, _ = orig(self, params, _clone(cache), tokens, cur_len)
        return logits, cache
    return step


def _half_batch(orig):
    def step(self, params, cache, tokens, cur_len=None):
        logits, cache = orig(self, params, cache, tokens, cur_len)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, cache
    return step


def _altered_token(orig):
    def step(self, params, cache, tokens, cur_len=None):
        logits, cache = orig(self, params, cache, tokens, cur_len)
        logits = logits.clone()
        logits[0] = -logits[0]          # row 0 serves its worst token
        return logits, cache
    return step


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_token": _altered_token}
CELLS = {"dsv2lite-rag": ("repro_torch.models.transformer", "TransformerLM"),
         "mamba2-longdoc": ("repro_torch.models.ssm_lm", "SSMLM")}


def _run(name):
    res, _ = cell.run(name, SEED, 1.0, False, t_proc=time.time(),
                      device="cpu", overrides=copy.deepcopy(OVERRIDES))
    return res


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert res["compared"]["bookkeeping"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CELLS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    import importlib
    mod, cls = CELLS[name]
    klass = getattr(importlib.import_module(mod), cls)
    monkeypatch.setattr(klass, "decode_step",
                        FAULTS[fault](klass.decode_step))
    res = _run(name)
    assert not res["correct"], res["compared"]
    assert res["failed"] > 0
