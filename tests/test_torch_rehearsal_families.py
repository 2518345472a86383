"""``chip_smoke.py``'s families group on the CPU at smoke size, through
the plain versions: zamba2 (the engine refused), mamba2 (engine ==
lockstep, a ragged run, the unplaced packs), whisper (the encoder's
attention packed) and pixtral (the patch prefix) on one calibration
cache, and the kernel rows at their shapes."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_families_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("families", capsys, tmp_path, monkeypatch)
    check_rows(out, ["gemm_placed", "gemv_placed"], [5, 1])
    fam = out["families"]
    # the smoke configs' placements (pixtral: FFN + unembed only)
    assert [fam[k]["placed_cols"] for k in
            ("zamba", "mamba", "whisper", "pixtral")] == [512, 256, 768,
                                                          896]
    assert fam["pixtral"]["layers"] == 2 and fam["zamba"]["peak_gib"] is None
    assert "engine: the continuous-batching engine needs the batch on " \
        "axis 1" in text
    assert "engine: vlm/encdec families not supported yet" in text
    assert text.count("through the kernels == plain versions, bit for "
                      "bit") == 6
    assert "table MISS" in text and text.count("table HIT") == 2
    assert "100.0% of requests bit-identical" in text
    assert "decode from position 16" in text      # 8 patches + 8 tokens
