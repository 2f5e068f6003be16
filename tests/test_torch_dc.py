"""K2's decomposition proven on the CPU: the segmented scan of threshold
functions (ops/bs_cuda.py::dc_stage_segmented_plain, the plain model of
csrc/bs_dc.cu, lane for lane) equals the Pallas kernel in interpret mode and
the port's plain DC stage, on DCs that make every step depend on the last,
on runs of ties that cross the lanes' segments, and on the range's ends and
the v3dc wrap."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same
from torch_dc_pack_cases import DC_CASES, dc_case

# NB = 6 (a lane per part is busy, 31 are the identity), 6 * 37 (a chain
# length that is not a multiple of 32) and 640x480; B = 1 and 5.
SHAPES = [(6, 1), (6 * 37, 5), (7200, 5)]
CODECS = [tbs.BS_V3, tbs.BS_V3DC]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("nb,batch", SHAPES)
@pytest.mark.parametrize("case", DC_CASES)
def test_segmented_dc_stage_matches_pallas(case, nb, batch, codec):
    dc = dc_case(case, batch, nb)
    want = jbsp.dc_stage_pallas(jnp.asarray(dc), codec, interpret=True)
    plain = bs_cuda.dc_stage_plain(torch.from_numpy(dc), codec)
    got = bs_cuda.dc_stage_segmented_plain(torch.from_numpy(dc), codec)
    for name, w, p, g in zip(("bits", "code"), want, plain, got):
        assert_same(w, p, name=f"plain {name}")
        assert_same(w, g, name=f"segmented {name}")


@pytest.mark.parametrize("lanes", [1, 3, 7, 32, 64])
@pytest.mark.parametrize("nb", [6 * 37, 7200])
def test_segmented_dc_stage_any_lane_count(nb, lanes):
    """The decomposition holds for any number of lanes a part: one lane
    is the walk in order, more lanes than blocks leave lanes empty."""
    for case in ("all ties", "tie runs"):
        dc = torch.from_numpy(dc_case(case, 2, nb, seed=lanes))
        for codec in CODECS:
            want = bs_cuda.dc_stage_plain(dc, codec)
            got = bs_cuda.dc_stage_segmented_plain(dc, codec, lanes=lanes)
            for w, g in zip(want, got):
                assert torch.equal(w, g), (case, codec)


def test_dc_cases_are_adversarial():
    """The cases do what their names say."""
    ties = dc_case("all ties", 5, 7200)
    assert (ties % 4 == 2).all()
    runs = dc_case("tie runs", 5, 7200)
    assert (runs % 4 == 2).all() and (np.diff(runs, axis=1) == 0).mean() > 0.8
    ext = dc_case("extremes", 5, 7200)
    assert ext.min() == -512 and ext.max() == 510
    keys, _ = tbs.dc_chain(torch.from_numpy(ext), tbs.BS_V3)
    delta = ((keys ^ 0x100) - 0x100).abs()
    assert (delta > 0x80).any() and (delta == 0x80).any()
