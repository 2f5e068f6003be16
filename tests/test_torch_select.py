"""The scale search of K1 and K6, proven on the CPU through its plain
model (ops/bs_cuda.py::select_search_plain runs the kernels' search
evaluation for evaluation): the ladder bound equals the JAX package's, the
search equals the first-fit walk and the Pallas kernels (interpret mode)
for any seeds, also on frames whose subsample misleads it."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_kernels import _pix, _thresholds
from test_torch_parity import assert_same

NB = 96
B = 5


def _case(seed=61, nb=NB):
    """Pixel rows, |coefs| and thresholds: tight (fits only at its best
    scale), mid-range, unfittable (-1), loose, and far below zero."""
    pix = _pix(seed, B, nb)
    pix[1] //= 3                                  # a smoother frame
    thr = np.concatenate([_thresholds(pix), [-(10 ** 6)]]).astype(np.int32)
    ca = tbs.pixrows_to_coefs_zz(torch.from_numpy(pix)).abs()
    return pix, ca, torch.from_numpy(thr)


@pytest.fixture(scope="module")
def case():
    pix, ca, thr = _case()
    want = bs_cuda._first_fit(ca, thr)
    return pix, ca, thr, want


def _quant_col():
    return np.asarray(jbs.QUANT_PSX[jbs.ZAGZIG[1:]], np.int32)[:, None]


def _jax_ladder(ca, d):
    """psxavenc_tpu's ladder_lb on one (63, W) tile, inside a Pallas call
    in interpret mode (its lane rolls exist only there)."""
    def kernel(ca_ref, d_ref, out_ref):
        dd = d_ref[...]
        out_ref[...] = jbsp.ladder_lb(ca_ref[...], dd, dd >> 1)

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(ca.shape, jnp.int32),
        interpret=True)(jnp.asarray(ca), jnp.asarray(d))


def test_ladder_lb_plain_matches_jax():
    """Element for element on a (63, 128) tile, at scales 1, 7 and 40."""
    rng = np.random.default_rng(62)
    ca = np.abs(rng.integers(-3000, 3000, (63, 128))).astype(np.int32)
    ca[:, :40] //= 50                             # sparse columns: long runs
    for s in (1, 7, 40):
        d = _quant_col() * s
        want = _jax_ladder(ca, d)
        got = bs_cuda.ladder_lb_plain(torch.from_numpy(ca),
                                      torch.from_numpy(d))
        assert_same(want, got, name=f"ladder at scale {s}")
        assert int(got.sum()) > 0


def test_ladder_is_a_monotone_lower_bound():
    """Per frame, LB(s) <= exact bits(s) and LB never rises with s: the
    two facts that make any seed safe."""
    _, ca, _ = _case(seed=63, nb=222)
    prev = None
    for s in range(1, 64):
        lb = bs_cuda._ladder_totals(ca, s)
        assert (lb <= bs_cuda._exact_totals(ca, s)[0]).all(), s
        if prev is not None:
            assert (lb <= prev).all(), s
        prev = lb


def test_zero_test_equals_level_zero():
    """a < d - (d >> 1) iff the rounded level is 0, for every divisor a
    scale can give (16 .. 83 * 63), at the boundary and beside it."""
    d = torch.arange(16, 83 * 63 + 1, dtype=torch.int32)[:, None]
    z = d - (d >> 1)
    a = (z + torch.tensor([-2, -1, 0, 1, 2])[None, :]).clamp(min=0)
    a = torch.cat([a, torch.zeros_like(d), d, 2 * d - 1], dim=1)
    level = torch.div(a + (d >> 1), d, rounding_mode="floor")
    assert torch.equal(a < z, level == 0)
    assert torch.equal(tbs._div_rounded_fast(a, d.expand_as(a)), level)


@pytest.mark.parametrize("groups", [1, 4, 7])
def test_search_without_seeds_is_first_fit(case, groups):
    """The self-seeded search, for every number of scales a round of it
    probes, and its counts: one to three fused passes, no more rounds
    than a bisection of 1..63."""
    _, ca, thr, want = case
    got = bs_cuda.select_search_plain(ca, thr, None, groups)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    stats = got[3]
    assert (stats[:, 1] >= 1).all()
    assert (stats[:, 1] <= bs_cuda.MAX_FUSED).all()
    assert (stats[:, 3] >= 1).all() and (stats[:, 3] <= 6).all()
    if groups == 7:
        assert (stats[:, 3] == 2).all()
    assert not stats[:, bs_cuda.COUNT_STATS:].any()
    scale = want[0].tolist()
    assert scale[2] == 64 and scale[3] == 1 and scale[4] == 64


def test_search_matches_pallas_kernels(case):
    """The model's answers == select_scale_pix_pallas and
    select_scale_pallas in interpret mode (which carry their own seeds
    from frame to frame)."""
    pix, ca, thr, _ = case
    got = bs_cuda.select_search_plain(ca, thr, torch.tensor([9, 0, 64, 1, 63]),
                                      4)
    want = jbsp.select_scale_pix_pallas(jnp.asarray(pix.astype(np.int32)),
                                        jnp.asarray(thr.numpy()),
                                        interpret=True)
    for name, w, g in zip(("scale", "bits", "nz"), want, got):
        assert_same(w, g, name=name)
    c = tbs.pixrows_to_coefs_zz(torch.from_numpy(pix)).numpy()
    want = jbsp.select_scale_pallas(jnp.asarray(c), jnp.asarray(thr.numpy()),
                                    interpret=True)
    for name, w, g in zip(("scale", "bits", "nz"), want, got):
        assert_same(w, g, name=name)


@settings(max_examples=25, deadline=None)
@given(seeds=st.lists(st.one_of(st.integers(-70, 130),
                                st.sampled_from([0, 1, 63, 64, -5])),
                      min_size=B, max_size=B),
       offsets=st.lists(st.sampled_from([None, 0, 1, -1]), min_size=B,
                        max_size=B),
       groups=st.sampled_from([1, 3, 7]))
def test_search_is_exact_for_any_seeds(seeds, offsets, groups):
    """Drawn seeds, some replaced by the answer or the answer +-1: the
    answers never move."""
    _, ca, thr = _case()
    want = bs_cuda._first_fit(ca, thr)
    seeds = [s if o is None else int(want[0][k]) + o
             for k, (s, o) in enumerate(zip(seeds, offsets))]
    got = bs_cuda.select_search_plain(ca, thr, torch.tensor(seeds), groups)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w), seeds


def test_a_hit_costs_one_fused_pass(case):
    """Seeds equal to the answers: one self-seeding round (the subsample
    agrees with the seed at once) and the one fused pass, where the ladder
    rules out the scale below the answer (or the answer is 1); an
    unfittable frame (seed 63) costs the same: the pass shows that
    nothing below 63 fits and that 63 does not. A wrong seed costs a
    round at most, never a pass over the frame."""
    _, ca, thr, want = case
    seeds = want[0].clamp(max=63)
    stats = bs_cuda.select_search_plain(ca, thr, seeds, 4)[3][:, :4]
    none = bs_cuda.select_search_plain(ca, thr, None, 4)[3][:, :4]
    hits = 0
    for b, s in enumerate(want[0].tolist()):
        if s == 64:
            assert stats[b].tolist() == [0, 1, 0, 1]
        elif stats[b, 3] == 1 and (s == 1 or int(bs_cuda._ladder_totals(
                ca[b:b + 1], s - 1)) > int(thr[b])):
            assert stats[b].tolist() == [0, 1, 0, 1]
            hits += 1
        assert stats[b, 3] <= none[b, 3]
    assert hits >= 2
    for off in (5, -3, 40):
        wrong = bs_cuda.select_search_plain(ca, thr, seeds + off, 4)[3]
        assert torch.equal(wrong[:, :3], none[:, :3])
        assert (wrong[:, 3] <= none[:, 3] + 1).all()


def test_search_groups():
    """The scales one self-seeding round probes: 3 for K1's 480 threads
    and 7 for K6's 928 at 320x240; a small CTA or a large frame leaves
    one."""
    assert bs_cuda.search_groups(1800, bs_cuda.K1_THREADS) == 3
    assert bs_cuda.search_groups(1800, bs_cuda.K6_THREADS) == 7
    assert bs_cuda.search_groups(7200, 608) == 1
    assert bs_cuda.search_groups(96, 608) == bs_cuda.MAX_GROUPS
    assert bs_cuda.search_groups(1800, 32) == 1


def test_wrappers_take_and_ignore_seeds(case):
    """On the CPU the wrappers run the first-fit walk whatever the seeds,
    and zero a statistics output."""
    pix, ca, thr, want = case
    seeds = torch.tensor([3, 64, -5, 63, 1], dtype=torch.int64)
    stats = torch.full((B, len(bs_cuda.STAT_NAMES)), 7, dtype=torch.int32)
    got = bs_cuda.select_scale_pix(torch.from_numpy(pix), thr, seeds,
                                   stats_out=stats)
    c = tbs.pixrows_to_coefs_zz(torch.from_numpy(pix))
    got6 = bs_cuda.select_scale(c, thr, seeds)
    for g, g6, w in zip(got, got6, want):
        assert torch.equal(g, w) and torch.equal(g6, w)
    assert not stats.any()


@pytest.mark.parametrize("bad", [
    torch.tensor([5]), torch.tensor([[5] * B]), torch.tensor([5.0] * B),
    [5] * B, torch.empty(B, dtype=torch.int32, device="meta")],
    ids=["short", "2-d", "float", "list", "other device"])
def test_wrappers_reject_bad_seeds(case, bad):
    """Seeds are None or a (B,) integer tensor on the input's device."""
    pix, _, thr, _ = case
    pix = torch.from_numpy(pix)
    with pytest.raises(ValueError):
        bs_cuda.select_scale_pix(pix, thr, bad)
    with pytest.raises(ValueError):
        bs_cuda.select_scale(tbs.pixrows_to_coefs_zz(pix), thr, bad)


@pytest.mark.parametrize("seeds", ["none", "answers", "wrong"])
def test_misleading_subsample_gallops_and_bisects(seeds):
    """Frames flat on the subsample's blocks (it names scale 1) or flat
    everywhere else (it names a scale far too high): the stepping passes
    run out, the ladder gallops from the one-sided bracket and bisects,
    and the answers are the first fits all the same."""
    rng = np.random.default_rng(65)
    pix = torch.from_numpy(rng.integers(-128, 128, (4, 64, 222)).astype(
        np.int8))
    pix, thr = bs_cuda.misleading_frames(pix, scale=12)
    ca = tbs.pixrows_to_coefs_zz(pix).abs()
    want = bs_cuda._first_fit(ca, thr)
    assert ((want[0] >= 8) & (want[0] <= 12)).all()
    seed_t = {"none": None, "answers": want[0],
              "wrong": torch.tensor([63, 1, 0, 30])}[seeds]
    got = bs_cuda.select_search_plain(ca, thr, seed_t, 3)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    stats = got[3]
    if seeds != "answers":                # the seed only orders the rounds
        assert (stats[:, 0] >= 4).all()
        # Upward: one fused pass, then exact steps; downward: fused passes.
        assert stats[0::2, 1].tolist() == [1, 1]
        assert stats[1::2, 1].tolist() == [bs_cuda.MAX_FUSED] * 2
    low = bs_cuda.select_search_plain(_subsample_of(ca), thr, None, 3)[0]
    assert (low[0::2] == 1).all()         # what the subsample alone says


def _subsample_of(ca):
    """The subsample's blocks, eight times over: a frame of the subsample's
    statistics."""
    return bs_cuda._subsample(ca).repeat(1, 1, bs_cuda.SUBSAMPLE)


def test_constants_equal_the_kernel_source():
    """The plain model's constants are the ones csrc/bs_select.cu is
    compiled with (on a card the wrappers ask the built library too)."""
    import re

    from psxavenc_tpu_torch.ops import _build

    src = (_build.CSRC / "bs_select.cu").read_text()
    got = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                for name in ("kSubsample", "kMaxGroups", "kMaxFused",
                             "kPixMaxThreads", "kCoefMaxThreads", "kStats"))
    assert got == bs_cuda._CONSTANTS
    assert "psx_select_constants" in _build._SIGNATURES
