"""gemma-7b at full width, checked on the CPU: the placement of its packs
on a 32 x 65,536 grid and the launch plans of the placed and unplaced
bit-plane GEMM/GEMV at its shapes (on a machine without a GPU only these
tests reach the shapes the GPU runs), and the serve CLI with the engine's
scheduler flags at smoke size.

The plan checks mirror ``plan_ok`` of ``csrc/placed_gemm.cu`` and
``csrc/plane_gemm.cu`` (the kernels refuse any plan they reject) and
require each plan to fit ``SMEM_MAX`` at 132 SMs and at fewer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import placed_gemm, plane_gemm  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models.params import is_def  # noqa: E402
from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig  # noqa: E402
from repro_torch.pud.packer import packing_requests  # noqa: E402
from repro_torch.pud.placement import PlacementError, plan_placement  # noqa: E402,E501

WB = 4
ROWS = [1, 4, 32]                  # GEMV, batch-4 decode, a 32-row chunk
SMS = [132, 114, 66, 16]
ECR = 0.037                        # the calibrated grid's mean ECR
KN = [(k, n) for k in (3072, 24576) for n in (24576, 3072, 256000)]
SHAPES = {"layers_0_dense/mixer/wi": (3072, 24576),
          "layers_0_dense/mixer/wg": (3072, 24576),
          "layers_0_dense/mixer/wo": (24576, 3072),
          "unembed/w": (3072, 256000)}


def _meta(defs):
    if is_def(defs):
        return torch.empty(defs.shape, dtype=defs.dtype, device="meta")
    return {k: _meta(v) for k, v in sorted(defs.items())}


@pytest.fixture(scope="module")
def requests():
    params = _meta(get("gemma-7b").make_model().param_defs())
    return packing_requests(params, PUDGemvConfig(weight_bits=4,
                                                  packable=FFN_PACKABLE))


@pytest.fixture(scope="module")
def placement(requests):
    masks = np.random.default_rng(0).random((32, 65536)) < ECR
    return plan_placement(masks, requests)


def test_gemma_needs_the_32_subarray_grid(requests):
    """1,718,272 placed columns: more than 16 x 65,536 holds error-free,
    fewer than 32 x 65,536 does."""
    assert sum(r.total_cols for r in requests) == \
        28 * (24576 + 24576 + 3072) + 256000 == 1718272
    rng = np.random.default_rng(0)
    with pytest.raises(PlacementError):
        plan_placement(rng.random((16, 65536)) < ECR, requests)


def test_placement_windows_cover_subarray_boundaries(placement):
    """Window blocks stay a few percent wider than their 256 logical
    columns, also where a block crosses from one subarray to the next."""
    for name, tp in placement.entries.items():
        assert tp.block_cols == 256
        assert 256 < tp.window_block < 320, name
        cols = np.asarray(tp.phys_cols).reshape(-1, 256)
        crossing = (cols[:, 0] // 65536) != (cols[:, -1] // 65536)
        if name != "layers_0_dense/mixer/wo":
            assert crossing.any(), name


def placed_plan_ok(p, b, kw, n, window_block, block_cols, dense):
    """``plan_ok`` of ``csrc/placed_gemm.cu``."""
    rpw = 8 if dense else 1
    kc = p.stage_words
    tiles = -(-block_cols // p.tile_cols)
    need = placed_gemm.STAGES * p.stage_bytes + 16 + WB * kc * p.pk_row
    if p.tensor_cores:
        need += placed_gemm.TC_COLS * (8 * kc + placed_gemm.PAD) + \
            placed_gemm.TC_COLS * 4
    elif p.tile_cols < placed_gemm.THREADS:
        need = max(need, placed_gemm.THREADS * p.rows * 4)
    rows_ok = ((p.rows in (64, 128) and p.tile_cols == placed_gemm.TC_COLS
                and kc % 4 == 0) if p.tensor_cores else
               (p.rows in (1, 4, 8, 16) and p.tile_cols in (64, 128, 256)))
    if p.row_bytes:
        staged_ok = (p.row_bytes >= window_block + 15
                     and p.row_bytes % 16 == 0
                     and p.w_stage == WB * rpw * kc * p.row_bytes
                     and p.tab_bytes >= 4 * WB * rpw * kc
                     and WB * rpw * kc * (p.row_bytes // 16)
                     <= placed_gemm.MAX_COPIES * placed_gemm.THREADS
                     and p.row_bytes // 16 <= 256
                     and (p.pk_row >= window_block + 3 and p.pk_row % 16 == 0
                          if dense else p.pk_row == 0))
    else:
        staged_ok = p.w_stage == 0 and p.tab_bytes == 0 and p.pk_row == 0
    return (rows_ok and staged_ok and p.stages == placed_gemm.STAGES
            and kc >= 1 and p.split_words >= kc and p.split_words % kc == 0
            and p.n_split == -(-kw // p.split_words)
            and p.tiles_per_block == tiles and p.x_row >= 8 * kc
            and p.x_row % 16 == 0 and p.tab_bytes % 16 == 0
            and p.stage_bytes == p.w_stage + p.rows * p.x_row + p.tab_bytes
            and need <= p.smem_bytes <= placed_gemm.SMEM_MAX
            and p.grid == ((n // block_cols) * tiles, -(-b // p.rows),
                           p.n_split))


def plane_plan_ok(p, b, kw, n, dense):
    """``plan_ok`` of ``csrc/plane_gemm.cu``."""
    kc = p.stage_words
    tc = plane_gemm.TILE_COLS
    common = (p.split_words >= kc and p.split_words % kc == 0
              and p.n_split == -(-kw // p.split_words)
              and p.grid == (-(-n // tc), -(-b // p.rows), p.n_split)
              and kc in (4, 8, 16, 32) and p.stages == plane_gemm.STAGES
              and p.x_row == 8 * kc + plane_gemm.PAD
              and p.w_stage == WB * (8 if dense else 1) * kc * tc
              and p.stage_bytes == p.w_stage + p.rows * p.x_row
              and p.smem_bytes <= plane_gemm.SMEM_MAX)
    if not p.tensor_cores:
        return (common and p.rows in (1, 4, 16)
                and (2 if dense else 1) * kc >= plane_gemm.WARPS
                and p.smem_bytes >= plane_gemm.STAGES * p.stage_bytes
                and p.smem_bytes >= plane_gemm.WARPS * tc * 4)
    return (common and p.rows in (64, 128) and kc <= 16
            and p.smem_bytes >= plane_gemm.STAGES * p.stage_bytes
            + 2 * kc * plane_gemm.WT_STRIDE * 4)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_placed_plans_at_gemma_shapes(placement, name, b, sms):
    """Every placed pack of gemma at its real window tiling: the plan the
    wrapper makes is one the kernel accepts, fits shared memory, takes
    tensor cores from 17 rows, covers K once in whole stages and stages
    the window span."""
    tp = placement.entries[name]
    k, n = SHAPES[name]
    kw = -(-k // 8)
    for dense in (False, True):
        p = placed_gemm.plan_launch(b, kw, n, WB, tp.window_block,
                                    tp.block_cols, dense, sms)
        assert placed_plan_ok(p, b, kw, n, tp.window_block, tp.block_cols,
                              dense), p
        assert p.tensor_cores == (b >= placed_gemm.TC_MIN_ROWS)
        assert p.staged or dense
        spans = [(z * p.split_words, min(kw, (z + 1) * p.split_words))
                 for z in range(p.n_split)]
        assert spans[-1][1] == kw and all(lo < hi for lo, hi in spans)
    if b <= 16 and sms == 132:
        g = placed_gemm.plan_launch(b, kw, n, WB, tp.window_block,
                                    tp.block_cols, False, sms).grid
        assert g[0] * g[1] * g[2] >= sms       # at least a block per SM


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("kn", KN)
def test_placed_plans_at_every_k_and_n(kn, b, sms):
    """Every pairing of gemma's K and N, at a window block 12.5% wider than
    its 256 logical columns (the real packs' are 7-9% wider)."""
    k, n = kn
    kw = -(-k // 8)
    for dense in (False, True):
        p = placed_gemm.plan_launch(b, kw, n, WB, 288, 256, dense, sms)
        assert placed_plan_ok(p, b, kw, n, 288, 256, dense), p


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("kn", KN)
def test_unplaced_plans_at_gemma_shapes(kn, b, sms):
    k, n = kn
    kw = -(-k // 8)
    for dense in (False, True):
        p = plane_gemm.plan_launch(b, kw, n, WB, dense, sms)
        assert plane_plan_ok(p, b, kw, n, dense), p
        assert p.tensor_cores == (b >= plane_gemm.TC_MIN_ROWS)


def test_placed_plan_check_rejects_a_bad_plan(placement):
    """The mirror is not vacuous: a plan with one field off fails it."""
    import dataclasses
    tp = placement.entries["unembed/w"]
    p = placed_gemm.plan_launch(4, 384, 256000, WB, tp.window_block, 256,
                                False)
    for field, value in (("smem_bytes", placed_gemm.SMEM_MAX + 16),
                         ("row_bytes", tp.window_block),
                         ("n_split", p.n_split + 1)):
        bad = dataclasses.replace(p, **{field: value})
        assert not placed_plan_ok(bad, 4, 384, 256000, tp.window_block, 256,
                                  False), field
    q = plane_gemm.plan_launch(32, 384, 256000, WB, False)
    assert not plane_plan_ok(dataclasses.replace(q, stage_words=32), 32,
                             384, 256000, False)


def test_serve_cli_gemma_with_scheduler_flags(tmp_path, capsys):
    """``--arch gemma-7b`` smoke through the placed packs and the engine
    with chunked prefill, the prefix cache and SLO admission: the
    scheduler lines print and every request equals lockstep decode."""
    argv = ["--arch", "gemma-7b", "--preset", "smoke", "--pud-gemv",
            "--engine", "--chunk-prefill", "4", "--prefix-cache",
            "--slo-ms", "1e7", "--batch", "4", "--prompt-len", "10",
            "--gen", "3", "--batch-size", "2", "--calib-cache",
            str(tmp_path), "--fleet-subarrays", "8", "--fleet-cols", "512",
            "--device", "cpu"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "gemma-7b (smoke" in out and "placed physical columns" in out
    assert "chunked prefill: 12 chunks of 4 tokens (1 chunk shapes)" in out
    assert "prefix cache: 0 hits / 4 misses" in out
    assert "slo: 4 met / 0 missed (shed 0 at admission, 0 in flight;" in out
    assert "100.0% of requests bit-identical" in out
