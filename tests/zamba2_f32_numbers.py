"""The zamba2-7b float32 smoke model's numbers behind the split's
precision rule, printed (not a test): the one-device port's step-0
gradients against the reference's (the worst leaf over its scale), its
3-step loss and grad-norm trajectory against the reference's, and the
sharded step-0 gradients on (1, 2), (1, 4), (2, 2) and (4, 1) CPU meshes
against the one-device step's.  From the repo root (about 40 s):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/zamba2_f32_numbers.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_cpu  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _families import leaves, pair  # noqa: E402
from _mesh import PEAK_LR, _run, on_mesh, ref_batches  # noqa: E402
from _train import check_train_loss  # noqa: E402
from repro.runtime import optim as joptim  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.models.sharding_ctx import set_rules  # noqa: E402
from repro_torch.runtime import optim, steps  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

print("step-0 worst leaf vs reference:", check_train_loss("zamba2-7b", True))
jm, jp, m, p = pair("zamba2-7b", f32=True)
kw = dict(peak_lr=PEAK_LR, warmup_steps=2, total_steps=10,
          compress_grads=False)
jcfg, cfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)
jstep = jax.jit(jsteps.make_train_step(jm, jcfg, microbatches=2,
                                       batch_axes=None))
bs = ref_batches("zamba2-7b", m)
js, jmets = joptim.init_opt_state(jp, jcfg), []
for i, b in enumerate(bs):
    jp, js, met = jstep(jp, js, jax.tree.map(jnp.asarray, b), jnp.uint32(i))
    jmets.append({n: float(v) for n, v in met.items()})
step = steps.make_train_step(m, cfg, microbatches=2)
p1 = optim.tree_map(torch.clone, p)
_, _, mets = _run(step, p1, optim.init_opt_state(p1, cfg), bs)
for i, (a, b) in enumerate(zip(mets, jmets)):
    print("step", i + 1, "relative |port - reference|",
          {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")})
batch = {n: torch.from_numpy(v.copy())
         for n, v in ref_batches("zamba2-7b", m, n=1)[0].items()}
loss, grads = steps.microbatch_grads(m, p, batch)
one = dict(leaves(grads))
for shape in [(1, 2), (1, 4), (2, 2), (4, 1)]:
    sp, mesh, rules = on_mesh(m, p, shape)
    set_rules(rules)
    try:
        sl, sg = steps.sharded_microbatch_grads(m, sp, batch)
    finally:
        set_rules(None)
    got = dict(leaves(shd.gather_tree(sg, "cpu")))
    worst = max(float((g - one[k]).abs().max()) / float(one[k].abs().max())
                for k, g in got.items() if one[k].numel())
    exact = all(torch.equal(g, one[k]) for k, g in got.items())
    print(shape, "loss equal", float(sl) == float(loss), "worst leaf",
          worst, "bit for bit", exact)
