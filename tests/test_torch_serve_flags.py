"""The serve flags of this slice against the JAX package: pack widths and
attention packs (``--weight-bits``, ``--pud-attention``) on the qwen3-1.7b
smoke model (2 layers, d 64, vocab 256), the refusal of ``--tune`` on the
CPU, and the flags' defaults.

Weights come from the reference's ``init_params`` and cross over with
``from_numpy``.  Tolerance: ``test_torch_serve.py``'s packed one (atol
0.1; measured differences stay under 0.05, from bf16 rounding of the
activations); packs are held bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH, B, S = "qwen3-1.7b", 4, 16
MAX_LEN = S + 7
ATOL_PACKED = 0.1


@pytest.fixture(scope="module")
def models():
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get(ARCH).make_smoke(), params


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("wb", [2, 3, 4, 6, 8])
def test_weight_bits_and_attention_packs_equal_reference(models, wb):
    """``--weight-bits wb --pud-attention`` packs (FFN, attention, unembed)
    in both packages: the packs bit-equal, prefill and two teacher-forced
    decode steps through them within the packed tolerance."""
    from repro.pud.gemv import ATTN_PACKABLE as J_ATTN
    from repro.pud.gemv import FFN_PACKABLE as J_FFN
    from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,
                                      PUDGemvConfig)
    jmodel, jparams, model, params = models
    js = JSession.open(ARCH, backend="reference")
    jpacked = js.pack(jparams, JGemvCfg(weight_bits=wb,
                                        packable=J_FFN + J_ATTN))
    s = PUDSession.open(ARCH, backend="reference", device="cpu")
    packed = s.pack(params, PUDGemvConfig(weight_bits=wb,
                                          packable=FFN_PACKABLE
                                          + ATTN_PACKABLE))
    assert packed.weight_bits == jpacked.weight_bits == wb
    assert list(packed.tensors) == list(jpacked.tensors)
    assert any("attn" in n for n in packed.tensors)
    for name, pt in packed.tensors.items():
        jt = jpacked.tensor(name)
        assert pt.n_bits == wb and pt.layout == jt.layout
        np.testing.assert_array_equal(pt.planes.numpy(),
                                      np.asarray(jt.planes))
        np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(jt.scale))
    toks, feed = _tokens(wb, (B, S)), _tokens(wb + 10, (2, B, 1))
    jl, jc = jmodel.prefill(jpacked.params, jnp.asarray(toks),
                            max_len=MAX_LEN)
    with torch.inference_mode():
        logits, cache = model.prefill(packed.params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_PACKED)
    for i in range(2):
        jl, jc = jmodel.decode_step(jpacked.params, jc, jnp.asarray(feed[i]),
                                    jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = model.decode_step(
                packed.params, cache, torch.from_numpy(feed[i]), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL_PACKED)


def test_serve_weight_bits_and_attention_flags(tmp_path, capsys):
    argv = ["--preset", "smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "2", "--pud-gemv", "--pud-attention", "--weight-bits",
            "6", "--calib-cache", str(tmp_path), "--fleet-subarrays", "8",
            "--fleet-cols", "512", "--device", "cpu"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "(6-bit planes, 8 projections packed, placed physical" in out


def test_tune_on_the_cpu_is_refused_with_a_clear_error(capsys):
    from repro_torch.launch.serve import parse_args
    with pytest.raises(SystemExit) as e:
        parse_args(["--pud-gemv", "--tune", "--device", "cpu"])
    assert e.value.code == 2
    assert "--tune times the CUDA kernels' launch plans and needs the GPU" \
        in capsys.readouterr().err
    with pytest.raises(SystemExit):
        parse_args(["--tune"])
    assert "--tune requires --pud-gemv" in capsys.readouterr().err


def test_serve_new_flag_defaults_match_reference():
    """``--weight-bits``, ``--pud-attention``, ``--tune`` and the seed take
    the reference's defaults (read from its ``main``), and
    ``DEFAULT_SEED`` is the reference's."""
    import ast
    import inspect

    from repro.launch import serve as j_serve
    from repro_torch.launch import serve
    want = {}
    for node in ast.walk(ast.parse(inspect.getsource(j_serve.main))):
        if (isinstance(node, ast.Call) and node.args
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                want[node.args[0].value] = ast.literal_eval(kw["default"])
            elif kw.get("action") is not None:
                want[node.args[0].value] = False
    ns = serve.parse_args([])
    assert ns.weight_bits == want["--weight-bits"] == 4
    assert ns.pud_attention is want["--pud-attention"] is False
    assert ns.tune is want["--tune"] is False
    assert serve.DEFAULT_SEED == j_serve.DEFAULT_SEED == ns.seed
