"""The autotuner's CPU side: tuning keys, plans and their stamps, the
candidate space against the contract checker and against a literal
transcription of the kernels' ``plan_ok``, the tuning cache, and the
refusals (no tuning on the CPU, no silent fallback from a rejected plan).

Everything here is exact: keys and plans are strings and integers, and a
plan never changes a GEMM's integers (the plain versions run on the CPU).
The CUDA cases (every candidate at the tuning phase's shapes against the
plain version) are in ``test_torch_cuda_kernels.py``.
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.kernels.autotune import tuning_key as j_tuning_key  # noqa: E402
from repro_torch.analysis.contracts import (KernelCall,  # noqa: E402
                                            check_placed_plan,
                                            check_plane_plan, plan_kernel,
                                            synthetic_placed)
from repro_torch.analysis.errors import ContractViolation  # noqa: E402
from repro_torch.kernels import (autotune, ops, placed_gemm,  # noqa: E402
                                 plane_gemm, ref)
from repro_torch.kernels.autotune import (TunedPlan,  # noqa: E402
                                          candidate_plans, plan_for_entry,
                                          row_class, tune_kernel,
                                          tuning_key, valid_candidates)
from repro_torch.runtime import tune  # noqa: E402
from repro_torch.runtime.tune import TuningCache  # noqa: E402

H100 = {"name": "NVIDIA H100 80GB HBM3", "sms": 132}


@pytest.mark.parametrize("entry", ["gemv", "gemm"])
@pytest.mark.parametrize("layout", ["dense", "bitpack8"])
@pytest.mark.parametrize("placed", [False, True])
def test_tuning_key_equals_reference(entry, layout, placed):
    for b, k, n, wb in ((1, 2048, 6144, 4), (32, 6144, 2048, 8),
                        (4, 300, 172, 2)):
        assert tuning_key(entry, b, k, n, wb, layout, placed) == \
            j_tuning_key(entry, b, k, n, wb, layout, placed)


def test_tuned_plan_round_trips_and_rejects_unknown_fields():
    plan = TunedPlan(tensor_cores=False, rows=16, stage_words=8, n_split=1)
    assert TunedPlan.from_dict(plan.to_dict()) == plan
    assert TunedPlan().is_default() and TunedPlan().to_dict() == {}
    assert TunedPlan.from_dict(json.loads(json.dumps(plan.to_dict()))) \
        == plan
    for bad in ({"n_block": 128}, {"rows": 4, "b_block": 8}):
        with pytest.raises(ValueError, match="unknown TunedPlan fields"):
            TunedPlan.from_dict(bad)


def test_row_classes_pick_the_stamped_plan():
    a, b, c = TunedPlan(rows=1), TunedPlan(rows=4), TunedPlan(rows=64)
    stamp = (("gemm", b), ("gemm_tc64", c), ("gemv", a))
    assert [row_class(x) for x in (1, 2, 16, 17, 64, 65, 128)] == \
        ["gemv", "gemm", "gemm", "gemm_tc64", "gemm_tc64", "gemm_tc128",
         "gemm_tc128"]
    assert plan_for_entry(stamp, row_class(1)) is a
    assert plan_for_entry(stamp, row_class(8)) is b
    assert plan_for_entry(stamp, row_class(32)) is c
    assert plan_for_entry(stamp, row_class(128)) is None     # prefill
    assert plan_for_entry((("gemv", a),), "gemm") is None   # heuristic
    assert plan_for_entry(None, "gemv") is None
    assert plan_for_entry(b, "gemm_tc128") is b              # one for all


# ---- the candidate space ----------------------------------------------

#: (B, K, N, WB, layout, placed): decode, dp4a GEMM and tensor-core rows
#: of the main path's projections, odd shapes and other plane counts
GRID = [(b, k, n, wb, layout, placed)
        for b in (1, 3, 4, 16, 17, 32, 64, 128)
        for k, n in ((2048, 6144), (6144, 2048), (2048, 1024), (300, 172))
        for wb in (4, 8)
        for layout in ("bitpack8", "dense")
        for placed in (False, True)
        if not (wb == 8 and k == 300)]


def _problem(b, k, n, wb, layout, placed):
    kw = -(-k // 8)
    geo = {}
    if placed:
        window, pwb, _ = synthetic_placed(n, pad=16)
        geo = dict(window=window, window_block=pwb)
    call = KernelCall(entry="gemv" if b == 1 else "gemm", b=b, k=k, n=n,
                      wb=wb, layout=layout,
                      logical_k=k if layout == "bitpack8" else None, **geo)
    return call, kw


def _candidates(call):
    return candidate_plans(call.entry, call.b, call.k, call.n,
                           layout=call.layout, placed_window=call.window,
                           pack_window_block=call.window_block, wb=call.wb)


def test_candidates_pass_the_contract_checker():
    """Every candidate the search space offers passes the checker: the
    tuner never has to drop one, and the heuristic comes first."""
    n_plans = 0
    for g in GRID:
        call, _ = _problem(*g)
        plans = _candidates(call)
        assert plans[0].is_default() and len(set(plans)) == len(plans)
        shape = (call.wb, call.resolved_plane_k(), call.window or call.n)
        assert valid_candidates(
            plans, call.entry, (call.b, call.k), shape, layout=call.layout,
            logical_k=call.logical_k,
            col_ids=torch.zeros(call.n) if call.window else None,
            window_block=call.window_block) == plans
        n_plans += len(plans)
    assert n_plans > 3 * len(GRID)


def test_candidates_cover_both_paths_and_a_single_split():
    """From 17 to 64 rows dp4a tiles compete with the 64-row tensor-core
    block, and at decode shapes a single split (no zeroed output, no
    atomics) is a candidate."""
    call, _ = _problem(32, 2048, 6144, 4, "bitpack8", True)
    paths = {(p.tensor_cores, p.rows) for p in _candidates(call)[1:]}
    assert (True, 64) in paths and (False, 16) in paths
    call, _ = _problem(4, 2048, 6144, 4, "bitpack8", True)
    assert any(p.n_split == 1 and p.rows == 4 for p in _candidates(call))
    call, _ = _problem(1, 6144, 2048, 4, "bitpack8", False)
    plans = _candidates(call)[1:]
    assert {(p.tensor_cores, p.rows) for p in plans} == {(False, 1)}


# ---- a literal transcription of plan_ok (csrc/*.cu) --------------------


def _placed_plan_ok(P, B, K, Kw, W, N, WB, window_block, block_cols,
                    dense) -> bool:
    """``launch`` + ``plan_ok`` of csrc/placed_gemm.cu, line by line."""
    if (WB < 1 or WB > 8 or window_block < 1 or block_cols < 1 or B < 1
            or N < 1 or N % block_cols
            or W != (N // block_cols) * window_block or K > Kw * 8
            or K <= (Kw - 1) * 8):
        return False
    kStages, kThreads, kTcCols, kPad = 4, 256, 128, 16
    kMaxSmem, kMaxCopies = 232448, 8
    rpw = 8 if dense else 1
    KC = P.stage_words
    tiles = (block_cols + P.tile_cols - 1) // P.tile_cols
    staged = P.row_bytes != 0
    need_smem = kStages * P.stage_bytes + 16 + WB * KC * P.pk_row
    if P.tensor_cores:
        need_smem += kTcCols * (8 * KC + kPad) + kTcCols * 4
    elif P.tile_cols < kThreads and kThreads * P.rows * 4 > need_smem:
        need_smem = kThreads * P.rows * 4
    rows_ok = ((P.rows in (64, 128)) and P.tile_cols == kTcCols
               and KC % 4 == 0) if P.tensor_cores else \
        ((P.rows in (1, 4, 8, 16)) and P.tile_cols in (64, 128, 256))
    if staged:
        staged_ok = (P.row_bytes >= window_block + 15
                     and P.row_bytes % 16 == 0
                     and P.w_stage == WB * rpw * KC * P.row_bytes
                     and P.tab_bytes >= 4 * WB * rpw * KC
                     and WB * rpw * KC * (P.row_bytes // 16)
                     <= kMaxCopies * kThreads
                     and P.row_bytes // 16 <= 256
                     and ((P.pk_row >= window_block + 3
                           and P.pk_row % 16 == 0) if dense
                          else P.pk_row == 0))
    else:
        staged_ok = P.w_stage == 0 and P.tab_bytes == 0 and P.pk_row == 0
    return (rows_ok and staged_ok and P.stages == kStages and KC >= 1
            and P.split_words >= KC and P.split_words % KC == 0
            and P.n_split == (Kw + P.split_words - 1) // P.split_words
            and P.tiles_per_block == tiles and P.x_row >= 8 * KC
            and P.x_row % 16 == 0 and P.tab_bytes % 16 == 0
            and P.stage_bytes == P.w_stage + P.rows * P.x_row + P.tab_bytes
            and P.smem_bytes >= need_smem and P.smem_bytes <= kMaxSmem
            and P.grid[0] == (N // block_cols) * tiles
            and P.grid[1] == (B + P.rows - 1) // P.rows
            and P.grid[2] == P.n_split)


def _plane_plan_ok(P, B, K, Kw, N, WB, dense) -> bool:
    """``launch`` + ``plan_ok`` of csrc/plane_gemm.cu, line by line."""
    if (WB < 1 or WB > 8 or B < 1 or N < 1 or K < 1 or K > Kw * 8
            or K <= (Kw - 1) * 8):
        return False
    kStages, kTileCols, kPad, kWarps, kWtStride = 4, 128, 16, 8, 136
    kMaxSmem = 232448
    KC = P.stage_words
    rpw = 8 if dense else 1
    common = (P.split_words >= KC and P.split_words % KC == 0
              and P.n_split == (Kw + P.split_words - 1) // P.split_words
              and P.grid[0] == (N + kTileCols - 1) // kTileCols
              and P.grid[1] == (B + P.rows - 1) // P.rows
              and P.grid[2] == P.n_split and KC in (4, 8, 16, 32)
              and P.stages == kStages and P.x_row == 8 * KC + kPad
              and P.w_stage == WB * rpw * KC * kTileCols
              and P.stage_bytes == P.w_stage + P.rows * P.x_row
              and P.smem_bytes <= kMaxSmem)
    if not P.tensor_cores:
        return (common and P.rows in (1, 4, 16)
                and (2 if dense else 1) * KC >= kWarps
                and P.smem_bytes >= kStages * P.stage_bytes
                and P.smem_bytes >= kWarps * kTileCols * 4)
    return (common and P.rows in (64, 128) and KC <= 16
            and P.smem_bytes >= kStages * P.stage_bytes
            + 2 * KC * kWtStride * 4)


def _verdicts(call, kw, plan):
    """(checker accepts, transcribed plan_ok accepts) of ``plan`` as
    ``call`` launches it (the GEMV entry's one-row rule included)."""
    dense = call.layout == "dense"
    try:
        plan_kernel(dataclasses.replace(call, tuned=plan))
        ours = True
    except ContractViolation:
        ours = False
    if call.window is not None:
        pwb = call.window_block
        bc = call.n // (call.window // pwb)
        p = placed_gemm.plan_launch(call.b, kw, call.n, call.wb, pwb, bc,
                                    dense, 132, plan)
        theirs = _placed_plan_ok(p, call.b, call.k, kw, call.window,
                                 call.n, call.wb, pwb, bc, dense)
    else:
        p = plane_gemm.plan_launch(call.b, kw, call.n, call.wb, dense, 132,
                                   plan)
        theirs = _plane_plan_ok(p, call.b, call.k, kw, call.n, call.wb,
                                dense)
    if call.entry == "gemv":
        theirs = theirs and not p.tensor_cores and p.rows == 1
    if plan is not None and plan.n_split is not None:
        theirs = theirs and p.n_split == plan.n_split
    return ours, theirs


def test_checker_agrees_with_plan_ok_on_every_candidate():
    """The checker's verdict equals the kernels' ``plan_ok`` (transcribed)
    on every candidate and on plans outside the candidate space (every
    row instance, stage size and split, either path), accepted or not."""
    seen = {True: 0, False: 0}
    for g in GRID:
        call, kw = _problem(*g)
        plans = list(_candidates(call))
        for tc in (False, True):
            for rows in (1, 2, 4, 8, 16, 64, 128):
                for kc in (1, 2, 4, 8, 16, 32):
                    plans.append(TunedPlan(tc, rows, kc))
        plans += [TunedPlan(n_split=s) for s in (1, 2, 3, 64)]
        for plan in plans:
            ours, theirs = _verdicts(call, kw, plan)
            assert ours == theirs, (g, plan)
            seen[ours] += 1
    assert seen[True] > 1000 and seen[False] > 1000


@pytest.mark.parametrize("plan,call_kw,invariant", [
    (TunedPlan(rows=2), dict(b=4, layout="bitpack8"), "rows-instantiated"),
    (TunedPlan(tensor_cores=True, rows=32), dict(b=32, layout="bitpack8"),
     "rows-instantiated"),
    (TunedPlan(tensor_cores=True, stage_words=2),
     dict(b=32, layout="bitpack8"), "tc-stage-words"),
    (TunedPlan(stage_words=16), dict(b=4, layout="dense"), "copies"),
    (TunedPlan(rows=4), dict(b=1, layout="bitpack8"), "gemv-plan"),
])
def test_bad_tuned_plans_name_their_invariant(plan, call_kw, invariant):
    window, pwb, _ = synthetic_placed(512, pad=8)
    b = call_kw["b"]
    call = KernelCall(entry="gemv" if b == 1 else "gemm", k=2048, n=512,
                      window=window, window_block=pwb,
                      logical_k=2048 if call_kw["layout"] == "bitpack8"
                      else None, tuned=plan, **call_kw)
    with pytest.raises(ContractViolation) as e:
        plan_kernel(call)
    assert e.value.invariant == invariant


def test_shared_memory_over_the_limit_is_named():
    """Through a tuned plan (unplaced dense, 8 planes, 16 stage words on
    tensor cores) and through a hand-made plan of the placed kernel."""
    with pytest.raises(ContractViolation) as e:
        plan_kernel(KernelCall(entry="gemm", b=128, k=2048, n=512, wb=8,
                               tuned=TunedPlan(stage_words=16)))
    assert e.value.invariant == "smem-max"
    window, pwb, _ = synthetic_placed(512, pad=8)
    p = placed_gemm.plan_launch(4, 256, 512, 4, pwb, 256, False)
    bad = dataclasses.replace(p, smem_bytes=placed_gemm.SMEM_MAX + 16)
    geo = dict(b=4, k=2048, kw=256, w_len=window, n=512, wb=4,
               window_block=pwb, block_cols=256, dense=False)
    check_placed_plan("gemm_placed", p, **geo)
    with pytest.raises(ContractViolation) as e:
        check_placed_plan("gemm_placed", bad, **geo)
    assert e.value.invariant == "smem-max"
    q = plane_gemm.plan_launch(4, 256, 512, 4, False)
    with pytest.raises(ContractViolation) as e:
        check_plane_plan("gemm", dataclasses.replace(q, rows=8), b=4,
                         k=2048, kw=256, n=512, wb=4, dense=False)
    assert e.value.invariant == "rows-instantiated"


def test_tuned_plans_override_only_their_fields():
    """None keeps the heuristic's choice; a full plan is built as told."""
    h = placed_gemm.plan_launch(4, 256, 6144, 4, 272, 256, False)
    assert placed_gemm.plan_launch(4, 256, 6144, 4, 272, 256, False, 132,
                                   TunedPlan()) == h
    one = placed_gemm.plan_launch(4, 256, 6144, 4, 272, 256, False, 132,
                                  TunedPlan(n_split=1))
    assert one.n_split == 1 and one.rows == h.rows \
        and one.stage_words == h.stage_words and one.grid[2] == 1
    tc = plane_gemm.plan_launch(32, 256, 6144, 4, False, 132,
                                TunedPlan(tensor_cores=False, rows=16))
    assert not tc.tensor_cores and tc.rows == 16 and tc.grid[1] == 2


# ---- the wrappers and ops: a stamped plan never gives way ---------------


def _pack(k=256, n=512, placed=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int32)
    planes = ref.pack_bitplanes(w, 4)
    cols = pwb = None
    if placed:
        window, pwb, ids = synthetic_placed(n, pad=8)
        cols = torch.from_numpy(ids)
        win = torch.zeros((4, k, window), dtype=torch.int8)
        win[:, :, cols.long()] = planes
        planes = win
    x = torch.randint(-127, 128, (4, k), generator=g, dtype=torch.int8)
    return x, ref.pack_plane_words(planes), cols, pwb, w


def test_rejected_stamped_plan_raises_on_every_path():
    x, words, cols, pwb, w = _pack()
    bad = TunedPlan(rows=2)
    kw = dict(layout="bitpack8", logical_k=256, window_block=pwb)
    with pytest.raises(ContractViolation):
        placed_gemm.gemm_placed(x, words, cols, tile_plan=bad, **kw)
    scale = torch.ones(512)
    for backend in ("cuda", "reference"):
        with pytest.raises(ContractViolation):
            ops.pud_matmul(x.float(), words, scale, col_ids=cols,
                           backend=backend, layout="bitpack8",
                           logical_k=256, window_block=pwb,
                           tile_plan=(("gemm", bad),))
    with pytest.raises(ContractViolation):
        plane_gemm.gemm(x, words[:, :, :512].contiguous(), logical_k=256,
                        tile_plan=TunedPlan(stage_words=4))


def test_valid_stamped_plans_change_no_integer():
    x, words, cols, pwb, w = _pack()
    want = (x.double() @ w.double()).to(torch.int32)
    kw = dict(layout="bitpack8", logical_k=256, window_block=pwb)
    for plan in candidate_plans("gemm", 4, 256, 512, layout="bitpack8",
                                placed_window=words.shape[-1],
                                pack_window_block=pwb):
        got = placed_gemm.gemm_placed(x, words, cols, tile_plan=plan, **kw)
        assert torch.equal(got, want)
    xf = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    scale = torch.rand(512) + 0.5
    base = ops.pud_matmul(xf, words, scale, col_ids=cols, **kw)
    stamp = (("gemm", TunedPlan(rows=16, n_split=1)),)
    assert torch.equal(ops.pud_matmul(xf, words, scale, col_ids=cols,
                                      tile_plan=stamp, **kw), base)
    assert torch.equal(ops.pud_gemv(xf, words, scale, col_ids=cols,
                                    check_contracts=True, **kw), base)


def test_tune_kernel_raises_on_the_cpu():
    x, words, cols, pwb, _ = _pack()
    with pytest.raises(RuntimeError, match="no kernel to tune"):
        tune_kernel("gemm", x, words, col_ids=cols, window_block=pwb,
                    layout="bitpack8", logical_k=256)


def test_median_time_on_the_cpu_times_the_host():
    calls = []
    t, out = autotune.median_time(lambda: calls.append(1) or len(calls),
                                  "cpu", warmup=2, reps=3)
    assert t >= 0 and out == 5 and len(calls) == 5


# ---- the tuning cache ---------------------------------------------------


def test_tuning_cache_round_trips_per_card(tmp_path):
    cache = TuningCache(tmp_path, device=H100)
    key = tuning_key("gemm", 4, 2048, 6144, 4, "bitpack8", True)
    plan = TunedPlan(tensor_cores=False, rows=4, stage_words=8, n_split=1)
    stats = {"tuned_s": 1e-5, "heuristic_s": 2e-5, "speedup": 2.0,
             "n_candidates": 12}
    assert cache.load(key) is None
    cache.save(key, plan, stats)
    assert cache.load(key) == plan
    assert cache.load_entry(key)["stats"] == stats
    assert TuningCache(tmp_path, device=H100).load(key) == plan
    # another card, another SM count, no card: a miss, never a hit
    for dev in ({"name": "NVIDIA H100 PCIe", "sms": 114},
                {"name": H100["name"], "sms": 114}, None):
        assert TuningCache(tmp_path, device=dev).load(key) is None
    other = TuningCache(tmp_path, device={"name": "NVIDIA A100", "sms": 108})
    other.save(key, TunedPlan(rows=16), stats)
    assert cache.load(key) == plan and other.load(key) == TunedPlan(rows=16)
    assert cache.stats()["entries"] == 2
    # another kernel fingerprint, a torn file, a foreign plan field: misses
    assert TuningCache(tmp_path, fingerprint="0" * 16,
                       device=H100).load(key) is None
    path = cache._path(key)
    entry = json.loads(path.read_text())
    path.write_text(json.dumps(dict(entry, plan={"n_block": 128})))
    assert cache.load(key) is None
    path.write_text("{torn")
    assert cache.load(key) is None and cache.load_entry(key) is None
    assert cache.evict(key) == 2 and cache.evict() == 0


def test_fingerprint_follows_every_kernel_source(tmp_path):
    pkg = tmp_path / "repro_torch"
    for name in tune.KERNEL_SOURCES:
        (pkg / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(tune.PACKAGE / name, pkg / name)
    base = tune.kernels_fingerprint(pkg)
    assert base == tune.kernels_fingerprint()
    assert len(tune.KERNEL_SOURCES) == 9
    assert sum(n.startswith("csrc/") for n in tune.KERNEL_SOURCES) == 4
    for name in tune.KERNEL_SOURCES:
        path = pkg / name
        data = path.read_bytes()
        path.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
        assert tune.kernels_fingerprint(pkg) != base, name
        path.write_bytes(data)
    assert tune.kernels_fingerprint(pkg) == base


def test_tuning_cache_cli(tmp_path, capsys):
    cache = TuningCache(tmp_path, device=H100)
    key = tuning_key("gemv", 1, 2048, 6144, 4, "bitpack8", True)
    cache.save(key, TunedPlan(rows=1, stage_words=8, n_split=1),
               {"speedup": 1.25})
    assert tune.main(["--root", str(tmp_path), "--list"]) == 0
    out = capsys.readouterr().out
    assert key in out and "1.25x" in out and H100["name"] in out
    assert tune.main(["--root", str(tmp_path), "--stats"]) == 0
    assert "entries          1" in capsys.readouterr().out
    assert tune.main(["--fingerprint"]) == 0
    assert capsys.readouterr().out.strip() == tune.kernels_fingerprint()
    assert tune.main(["--root", str(tmp_path), "--evict", "all"]) == 0
    assert "evicted 1 tuning entry" in capsys.readouterr().out
    assert cache.entries() == []


def test_device_tag_of_the_cpu():
    assert tune.device_tag("cpu") == {"name": "cpu", "sms": 0}
    with pytest.raises(ValueError):
        TuningCache("unused").save("k", TunedPlan())


def test_candidate_plans_are_deterministic():
    a = candidate_plans("gemm", 4, 2048, 6144, layout="bitpack8",
                        placed_window=24 * 272, pack_window_block=272)
    b = candidate_plans("gemm", 4, 2048, 6144, layout="bitpack8",
                        placed_window=24 * 272, pack_window_block=272)
    assert a == b and len(a) > 12
    launch = {placed_gemm.plan_launch(4, 256, 6144, 4, 272, 256, False,
                                      132, p) for p in a}
    assert len(launch) == len(a)            # no two launch the same
    assert np.all([p.is_default() for p in a[:1]])
