"""The comparison that decides ``correct``.

Two numbers, each beside its limit (the cell's ``correct`` section):

* ``bookkeeping``: requests whose slot, admission step, finishing step,
  token count or shed flag differ from the schedule the traffic implies
  (``schedule.simulate``); limit 0.
* ``widest_gap``: over a sample of the requests the window finished,
  drawn from the seed with the longest always in it, the widest gap by
  which the logit of a token the engine served lies below the reference's
  best logit at that position (``reference/<module>.logits``).  Greedy
  serving is exact where the gap is 0; rounding moves near-ties.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from . import schedule
from .seeds import sub_seed


@dataclasses.dataclass
class Job:
    """What a reference needs: the benchmark's prompts, the schedule it
    worked out, the tokens the engine served (to judge), and which
    requests to compare."""
    prompts: dict             # id -> [S] int32
    served: dict              # id -> list of served tokens
    schedule: dict            # id -> (slot, admitted step, prompt length)
    n_waves: int
    batch: int
    max_len: int              # the engine's cache length (positions)
    packed: tuple             # names of the 4-bit projections
    compare: list             # ids compared


def sample(completions: dict, n: int, seed: int) -> list:
    """``n`` finished (not shed) requests drawn from the seed, the one with
    the most served tokens (lowest id on a tie) always among them."""
    done = sorted(k for k, c in completions.items() if not c.shed)
    if not done:
        return []
    longest = max(done, key=lambda k: (len(completions[k].tokens), -k))
    rest = [k for k in done if k != longest]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    pick = list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return sorted([longest] + [int(k) for k in pick])


def job_for(config: dict, traffic, completions: dict, n_waves: int,
            compare: list) -> Job:
    sched = schedule.simulate(traffic, n_waves)
    return Job(
        prompts={k: traffic.tokens(k) for k in sched},
        served={k: list(completions[k].tokens) if k in completions else []
                for k in sched},
        schedule={k: (v[0], v[1], traffic.item(k).prompt_len)
                  for k, v in sched.items()},
        n_waves=n_waves, batch=traffic.clients,
        max_len=traffic.max_prompt + traffic.max_output,
        packed=tuple(config["pud"]["packed"]), compare=compare)


def bookkeeping(traffic, completions: dict, n_waves: int) -> list:
    """Ids whose engine record differs from the implied schedule."""
    sched = schedule.simulate(traffic, n_waves)
    bad = [k for k in completions if k not in sched]
    for k, (slot, adm, fin, n, shed) in sched.items():
        c = completions.get(k)
        if c is None or (c.slot, c.admitted_step, c.finished_step,
                         len(c.tokens), bool(c.shed)) != (slot, adm, fin, n,
                                                          shed):
            bad.append(k)
    return sorted(bad)


def reference(config: dict):
    return importlib.import_module(f"pudbench.reference."
                                   f"{config['reference']}")


def gaps(logits: dict, tokens: dict) -> dict:
    """{id: [n] gaps}: the best logit less the logit of ``tokens[id][j]``
    at each row j."""
    out = {}
    for k, lg in logits.items():
        t = torch.as_tensor(tokens[k], device=lg.device).long()
        out[k] = (lg.amax(dim=-1) - lg.gather(1, t[:, None])[:, 0]).cpu(
        ).numpy()
    return out


def judge(config: dict, sizes: dict, weights: dict, traffic,
          completions: dict, n_waves: int, seed: int, limits: dict,
          n_sample: int) -> dict:
    """The compared numbers, each with its limit, and the verdict."""
    bad = bookkeeping(traffic, completions, n_waves)
    compare = sample(completions, n_sample, seed)
    job = job_for(config, traffic, completions, n_waves, compare)
    with torch.inference_mode():
        lg = reference(config).logits(sizes, weights, job, "bf16")
    g = gaps(lg, {k: job.served[k] for k in compare})
    widest = max((float(v.max()) for v in g.values()), default=float("nan"))
    n_tok = int(sum(v.size for v in g.values()))
    ok = (len(bad) <= limits["bookkeeping"] and np.isfinite(widest)
          and widest <= limits["widest_gap"] and n_tok > 0)
    failed = len(set(bad) | {k for k, v in g.items()
                             if not (v <= limits["widest_gap"]).all()})
    return {"correct": bool(ok), "failed": failed,
            "compared": {
                "widest_gap": {"value": widest,
                               "limit": limits["widest_gap"]},
                "bookkeeping": {"value": len(bad),
                                "limit": limits["bookkeeping"]}},
            "tokens_compared": n_tok, "gaps": g, "compare": compare}
