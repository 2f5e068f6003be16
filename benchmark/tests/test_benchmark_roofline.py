"""The frozen yardstick equals the program's utils/roofline.py on the
same counts (the copy may not drift from what it was frozen from without
a benchmark PR saying so)."""

import pytest

from benchlib import roofline as frozen

CASES = [
    ("fdct_select_work", (900, 1800, 1800, 1700)),
    ("fdct_select_work", (128, 1800, 2048, 256)),
    ("emit_prep_work", (900, 1800, 900 * 64 * 1800 * 2, 2_500_000)),
    ("place_work", (900, 1801, 0)),
    ("place_work", (128, 1801, 4534)),
    ("tail_work", (900, 1800)),
    ("tail_work", (900, 1800, 17, 900)),
    ("adpcm_work", (1, 503_000, 5, 4)),
    ("adpcm_work", (256, 7875, 5, 4)),
]


@pytest.mark.parametrize("name,args", CASES)
def test_work_functions_match_the_program(name, args):
    from psxavenc_tpu_torch.utils import roofline as program
    assert getattr(frozen, name)(*args) == getattr(program, name)(*args)


def test_peaks_match_the_program():
    from psxavenc_tpu_torch.utils import roofline as program
    chip = program.chip_for("NVIDIA H100 80GB HBM3")
    assert frozen.HBM_BYTES_PER_S == chip["hbm_bytes"]
    assert frozen.INT32_OPS_PER_S == chip["int32_ops"]
    n_bytes, ops = frozen.adpcm_work(4096, 1000, 5, 4)
    ms, _ = program.bound(n_bytes, ops)
    assert frozen.bound_s(n_bytes, ops) * 1e3 == pytest.approx(ms)
