"""The contract checker (``repro_torch.analysis``) against the reference's
(``repro.analysis.contracts``) on the operand and window checks the two
share, and the port's own gate: the sweep, the fixtures, the generated
shared-memory table, the CLI and the shard splits.

All exact: the checks are integer arithmetic on shapes and column ids.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.analysis import contracts as jc  # noqa: E402
from repro.analysis.errors import ContractViolation as JViolation  # noqa: E402
from repro.pud.placement import (PlacementError as JPlacementError,  # noqa: E402
                                 shard_column_slices as j_shard_slices)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.contracts import (KernelCall,  # noqa: E402
                                            check_kernel_args, check_pack,
                                            check_shard_slices, plan_kernel)
from repro_torch.analysis.errors import ContractViolation  # noqa: E402
from repro_torch.pud.gemv import pack_linear  # noqa: E402
from repro_torch.pud.placement import (PlacementError,  # noqa: E402
                                       shard_column_slices)

#: the reference's fixtures whose invariants the port keeps (the rest
#: name TPU tiles or its VMEM budget)
SHARED = ("oversized-window-block", "window-under-capacity",
          "inconsistent-logical-k", "word-count-drift",
          "col-ids-out-of-window", "col-ids-wrong-block", "unknown-layout")


def _port_call(jcall):
    return KernelCall(entry=jcall.entry, b=jcall.b, k=jcall.k, n=jcall.n,
                      wb=jcall.wb, layout=jcall.layout,
                      plane_k=jcall.plane_k, logical_k=jcall.logical_k,
                      window=jcall.window, window_block=jcall.window_block,
                      mode=jcall.mode)


def test_gate_is_clean():
    assert contracts.run_contracts() == []
    assert contracts.run_contracts(114) == []      # an H100 PCIe's SMs


@pytest.mark.parametrize("name", SHARED)
def test_shared_fixtures_trip_the_reference_invariant(name):
    """The reference's adversarial fixture and the port's trip the same
    invariant, through the same call."""
    fixtures = {f[0]: f for f in jc.adversarial_fixtures()}
    _, invariant, jcall, ids = fixtures[name]
    with pytest.raises(JViolation) as je:
        jc._check_pair(jcall, ids)
    with pytest.raises(ContractViolation) as pe:
        contracts._check_pair(_port_call(jcall), ids)
    assert je.value.invariant == pe.value.invariant == invariant


@pytest.mark.parametrize("fixture", contracts.adversarial_fixtures(),
                         ids=lambda f: f[0])
def test_each_port_fixture_trips_its_invariant(fixture):
    _, invariant, call, ids = fixture
    with pytest.raises(ContractViolation) as e:
        contracts._check_pair(call, ids)
    assert e.value.invariant == invariant


def test_valid_matrix_agrees_with_the_reference_on_operands():
    """Every call of the reference's valid matrix that the port's kernels
    take (the GEMV entry at one row) passes the port's checker, col_ids
    values included."""
    n = 0
    for jcall, ids in jc.default_matrix():
        if jcall.entry == "gemv" and jcall.b != 1:
            continue
        contracts._check_pair(_port_call(jcall), ids)
        n += 1
    assert n >= 30


def test_check_kernel_args_takes_tensors_and_counts():
    window, pwb, ids = contracts.synthetic_placed(512)
    col_ids = torch.from_numpy(ids)
    plan = check_kernel_args("gemm", (4, 256), (4, 32, window),
                             layout="bitpack8", logical_k=256,
                             col_ids=col_ids, window_block=pwb)
    assert plan == check_kernel_args("gemm", (4, 256), (4, 32, window),
                                     layout="bitpack8", logical_k=256,
                                     col_ids=512, window_block=pwb)
    bad = col_ids.clone()
    bad[3] = window
    with pytest.raises(ContractViolation, match="col-ids-range"):
        check_kernel_args("gemm", (4, 256), (4, 32, window),
                          layout="bitpack8", logical_k=256, col_ids=bad,
                          window_block=pwb)
    with pytest.raises(ContractViolation, match="gemv-plan"):
        check_kernel_args("gemv", (2, 256), (4, 32, 512),
                          layout="bitpack8", logical_k=256)
    with pytest.raises(ContractViolation, match="mode"):
        plan_kernel(KernelCall(entry="gemm", b=2, k=64, n=64,
                               mode="fused"))


def test_check_pack_uses_the_stamped_plan():
    from repro_torch.kernels.autotune import TunedPlan
    w = torch.randn(256, 512, generator=torch.Generator().manual_seed(0))
    pt = pack_linear(w, 4)
    assert len(check_pack(pt, batch=1)) == 2
    assert len(check_pack(pt, batch=4)) == 1
    stamped = pt.replace(tile_plan=(("gemm", TunedPlan(stage_words=4)),))
    check_pack(stamped, batch=1)                  # the GEMV class: none
    with pytest.raises(ContractViolation, match="dp4a-warps"):
        check_pack(stamped, batch=4)


def test_generated_table_is_in_sync_and_names_the_limit():
    assert contracts.check_doc_table(cli.README) == []
    block = contracts.doc_table_block()
    assert "232448" in block and "tensor cores, 64" in block
    assert block.count("\n| ") == 1 + 16           # header, 16 rows
    assert "docs/" not in str(cli.README)


def test_cli_runs_the_gate(capsys):
    assert cli.main(["--sms", "132"]) == 0
    out = capsys.readouterr().out
    assert "0 findings" in out and "in sync" in out
    assert cli.main(["--doc-table"]) == 0
    assert contracts.DOC_BEGIN in capsys.readouterr().out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 7, 8, 16, 33])
def test_shard_column_slices_equal_reference(n_shards):
    for n_cols in (1, 7, 128, 255, 256, 300, 512, 1000, 1024, 2048, 6144,
                   151936, 24576):
        spans, bc = shard_column_slices(n_cols, n_shards)
        assert (spans, bc) == j_shard_slices(n_cols, n_shards)
        check_shard_slices(spans, n_cols, bc)
        jc.check_shard_slices(spans, n_cols, bc)


def test_shard_column_slices_reject_what_the_reference_rejects():
    for args in ((0, 2), (8, 0), (-4, 2)):
        with pytest.raises(PlacementError):
            shard_column_slices(*args)
        with pytest.raises(JPlacementError):
            j_shard_slices(*args)


@pytest.mark.parametrize("spans,n,bc", [
    (((0, 256), (256, 512)), 512, 256),          # valid
    (((0, 128), (128, 512)), 512, 256),          # straddles a block
    (((0, 256), (300, 512)), 512, 256),          # gap
    (((0, 256),), 512, 256),                     # short
    (((0, 256), (256, 512)), 512, 300),          # block does not tile N
    (((0, 512), (512, 256)), 512, 256),          # negative span
    ((), 0, 256),                                # nothing, N 0
])
def test_check_shard_slices_rejects_what_the_reference_rejects(spans, n, bc):
    def verdict(fn, err):
        try:
            fn(spans, n, bc)
        except err as e:
            return e.invariant, e.tile
        return None
    assert verdict(check_shard_slices, ContractViolation) == \
        verdict(jc.check_shard_slices, JViolation)


def test_synthetic_placement_is_the_reference_one():
    for n in (64, 172, 512, 2048):
        for a, b in zip(contracts.synthetic_placed(n),
                        jc.synthetic_placed(n)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
