"""Wrappers and plain versions of the BS kernels K1-K3, K6 and K7, and
of the tail emission of blocks longer than the 256-bit window.

Counterpart of ``psxavenc_tpu/ops/bs_pallas.py``. Each kernel has:

- a plain PyTorch version (``*_plain``) computing the same integers, used
  for CPU tensors and as the reference the kernel is checked against;
- a wrapper that takes the plain version only for CPU tensors and, for
  CUDA tensors, launches the hand-written kernel (``csrc/``) or raises;
- a launch count in ``LAUNCHES``, incremented where the kernel launches.

The kernel sources carry the design notes: what each replaces, what bounds
it on the H100, and what the design does about it.
"""

import ctypes

import torch

from . import _build
from . import bs as bs_ops
from . import bitpack as bitpack_ops

TILE = 512  # coefficient lane padding, as psxavenc_tpu's select kernel

LAUNCHES = {"select_scale_pix": 0, "dc_stage": 0, "emit_prep": 0,
            "select_scale": 0, "emit_pack": 0, "emit_tail": 0}


def _on_cuda(t, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _require(t, dtype, ndim, name):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def nb_padded(nb):
    return -(-nb // TILE) * TILE


_SMS = {}


def sm_count(device):
    """The SM count of CUDA ``device`` (read once per device)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


# ------------------------------------------------------------------- K1

def _exact_totals(ca, s):
    """Exact AC (bits, nonzero count) per frame of |coefs| ``ca``
    (B, 63, NB) at scale s (1..63)."""
    d = bs_ops.quant_zz(ca.device)[None, :, None] * s
    mag = torch.div(ca + (d >> 1), d, rounding_mode="floor")
    nz = mag != 0
    run = bs_ops._runs(nz, 1)
    bits = torch.where(nz, bs_ops.ac_bits_closed_form(run, mag), 0)
    return (bits.sum(dim=(1, 2), dtype=torch.int32),
            nz.sum(dim=(1, 2), dtype=torch.int32))


def _first_fit(ca, thr_ac):
    """(scale, ac_bits, nz), each (B,) int32: the first s in 1..63 whose
    exact AC bit total of |coefs| ``ca`` (B, 63, NB) is <= thr_ac (64 if
    none, with ac_bits and nz 0). The scales are walked in order; a frame
    leaves the walk at its first fit."""
    B = ca.shape[0]
    dev = ca.device
    thr = thr_ac.to(device=dev, dtype=torch.int32)
    scale = torch.full((B,), 64, dtype=torch.int32, device=dev)
    bits = torch.zeros((B,), dtype=torch.int32, device=dev)
    nz = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev)          # frames without a fit
    for s in range(1, 64):
        if not active.numel():
            break
        b_s, n_s = _exact_totals(ca[active], s)
        fit = b_s <= thr[active]
        done = active[fit]
        scale[done] = s
        bits[done] = b_s[fit]
        nz[done] = n_s[fit]
        active = active[~fit]
    return scale, bits, nz


# ------------------------------------ the kernels' search, step for step

# The search's constants, which ``csrc/bs_select.cu`` has too: the first
# launch holds the two copies against each other (_check_constants).
SUBSAMPLE = 8          # self-seeding reads every eighth pair of blocks
MAX_GROUPS = 8         # scales one self-seeding round probes at most
MAX_FUSED = 3          # stepping passes before the ladder gallops and bisects
K1_THREADS = 480       # 15 warps: two even trips over 900 pairs of blocks
K6_THREADS = 928       # 29 warps: one pair of blocks per thread at 900
# The kernels' statistics per frame: full ladder evaluations, fused passes,
# exact evaluations, self-seeding rounds, which reader ran (0: shared
# memory, 1: global memory), and SM cycles before the search (K1's FDCT,
# K6's copy), in self-seeding rounds and in full evaluations.
STAT_NAMES = ("ladder", "fused", "exact", "sub_rounds", "global_reader",
              "fill_cycles", "seed_cycles", "eval_cycles")
COUNT_STATS = 4        # the first columns, which the plain model counts too
_CONSTANTS = (SUBSAMPLE, MAX_GROUPS, MAX_FUSED, K1_THREADS, K6_THREADS,
              len(STAT_NAMES))
_constants_checked = False


def _check_constants():
    """Raises unless the built kernels were compiled with this module's
    constants: the plain model of the search counts what the kernels do
    only then."""
    global _constants_checked
    if _constants_checked:
        return
    got = (ctypes.c_int * len(_CONSTANTS))()
    _build.lib().psx_select_constants(got)
    if tuple(got) != _CONSTANTS:
        raise RuntimeError(f"csrc/bs_select.cu was built with the constants "
                           f"{tuple(got)}, ops/bs_cuda.py has {_CONSTANTS}")
    _constants_checked = True


def ladder_lb_plain(ca, d):
    """The ladder lower-bound terms of |coefs| ``ca`` (..., 63, NB) at
    divisors ``d`` broadcastable to it: per nonzero, the run-0 code length
    of its level class plus a run-aware bonus (the torch counterpart of
    psxavenc_tpu's ``ladder_lb``, which proves the bound and that it never
    rises with the scale). level >= k iff ca + d // 2 >= k * d."""
    ge = bs_ops._ge
    t = ca + (d >> 1)
    nz = t >= d
    c2 = ge(t, 2 * d)
    c3 = ge(t, 3 * d)
    lb = 3 + 2 * c2 + c3 + 2 * ge(t, 4 * d) + ge(t, 5 * d) + 2 * ge(t, 7 * d)
    run = bs_ops._runs(nz, ca.ndim - 2)
    g = (run.clamp(max=3) + ge(run, 5) + ge(run, 8) + ge(run, 10)
         + 2 * ge(run, 14) + ge(run, 17))
    return torch.where(nz, lb + torch.where(run >= 1, c2 + c3, 0) + g, 0)


def _ladder_totals(ca, s):
    """The ladder lower bound per frame of ``ca`` (B, 63, NB) at scale s."""
    d = bs_ops.quant_zz(ca.device)[None, :, None] * s
    return ladder_lb_plain(ca, d).sum(dim=(1, 2), dtype=torch.int32)


def subsample_mask(nb, device):
    """(NB,) bool: the blocks the self-seeding reads, pairs (2j, 2j + 1)
    with j a multiple of SUBSAMPLE."""
    return (torch.arange(nb, device=device) >> 1) % SUBSAMPLE == 0


def _subsample(ca):
    return ca[..., subsample_mask(ca.shape[-1], ca.device)]


def misleading_frames(pix, scale=12):
    """Frames whose subsample says nothing true of them, made from pixel
    rows ``pix`` (B, 64, NB) int8 (for tests and measurements): the even
    frames are flat on the subsample's blocks, so self-seeding names scale
    1, and the odd frames flat on all the others, so it names a scale far
    too high. Returns (pix, thr_ac) with each threshold the frame's exact
    total at ``scale``: the answer is at most ``scale`` and, for noisy
    pixels, far from what the subsample names, so the search has to gallop
    and bisect with ladder evaluations."""
    sub = subsample_mask(pix.shape[2], pix.device)
    pix = pix.clone()
    pix[0::2] = torch.where(sub, 0, pix[0::2])
    pix[1::2] = torch.where(sub, pix[1::2], 0)
    ca = bs_ops.pixrows_to_coefs_zz(pix).abs()
    return pix, _exact_totals(ca, scale)[0]


def search_groups(nb, threads):
    """How many scales one self-seeding round of a ``threads``-wide CTA
    probes on a frame of ``nb`` blocks: the subsample's pairs take a group
    of whole warps (one pair a thread), and every such group of the CTA
    probes a scale of its own."""
    n_sub = -(-((nb + 1) // 2) // SUBSAMPLE)
    group = min(threads, -(-n_sub // 32) * 32)
    return min(threads // group, MAX_GROUPS)


def _group_probe(lo, hi, g, groups, hint):
    """The scale group g of ``groups`` probes inside (lo, hi): with a hint
    inside it the first two groups take the hint and the scale below, the
    others spread as they would without."""
    if lo < hint < hi:
        if g == 0:
            return hint
        if g == 1:
            return max(hint - 1, lo + 1)
        g -= 2
        groups -= 2
    return min(lo + max((hi - lo) * (g + 1) // (groups + 1), 1), hi - 1)


def _search_frame(ca, thr, seed, groups):
    """One frame of :func:`select_search_plain`: ca (63, NB)."""
    ca = ca[None]
    sub = _subsample(ca)
    count = dict.fromkeys(STAT_NAMES, 0)     # the kernels' columns stay 0
    # No scale up to lo fits (0: nothing known) and the ladder fits at hi
    # (64: nothing known). Every evaluation below only tightens the two
    # from a total it computed, so no seed can change the answer.
    lo, hi = 0, 64
    known = {}                       # scale: the fused passes' exact totals

    def ladder(s, data=ca):
        return int(_ladder_totals(data, s))

    def exact(s):
        bits, nz = _exact_totals(ca, s)
        return int(bits), int(nz)

    # The subsample's ladder, scaled to the frame, names a likely scale:
    # rounds of one probe per group, the first round around the caller's
    # seed.
    hint = seed if 1 <= seed <= 63 else 0
    slo, shi = 0, 64
    while shi - slo > 1:
        count["sub_rounds"] += 1
        for p in [_group_probe(slo, shi, g, groups, hint)
                  for g in range(groups)]:
            if ladder(p, sub) * SUBSAMPLE <= thr:
                shi = min(shi, p)
            else:
                slo = max(slo, p)
        hint = 0
    # A fused pass: the ladder at s - 1 and the exact totals at s from one
    # read of the whole frame. It usually closes the bracket; when the
    # subsample was off, the answer is most often the next scale on the
    # side the pass points to, so up to MAX_FUSED passes step that way:
    # upward an exact evaluation is enough (every scale below is known not
    # to fit), downward it takes a fused pass.
    s = min(shi, 63)
    exact_only = False
    for _ in range(MAX_FUSED):
        below = max(s - 1, 1)
        ladder_fits = False
        if exact_only:
            count["exact"] += 1
        else:
            count["fused"] += 1
            ladder_fits = ladder(below) <= thr
            if ladder_fits:
                hi = min(hi, below)
            else:
                lo = max(lo, below)
        known[s] = exact(s)
        if known[s][0] <= thr:               # the ladder is below the exact
            hi = min(hi, s)
        elif lo >= s - 1:                    # nothing below s fits, nor s
            lo = max(lo, s)
        if hi - lo <= 1:
            break
        if ladder_fits:
            s, exact_only = hi, False        # the answer is below s
        elif s < 63:
            s, exact_only = s + 1, True      # nothing up to s fits
        else:
            break

    # lower_bound of "the ladder fits": gallop away from a one-sided
    # bracket with doubling steps, bisect a two-sided one.
    step = 1
    while hi - lo > 1:
        if lo == 0 and hi < 64:
            probe, step = hi - step, 2 * step
        elif hi == 64 and lo > 0:
            probe, step = lo + step, 2 * step
        else:
            probe = (lo + hi) >> 1
        probe = min(max(probe, lo + 1), hi - 1)
        count["ladder"] += 1
        if ladder(probe) <= thr:
            hi = probe
        else:
            lo = probe

    # The exact walk upward from the bound's answer; the fused pass's
    # totals are not computed again.
    for s in range(hi, 64):
        if s in known:
            bits, nz = known[s]
        else:
            count["exact"] += 1
            bits, nz = exact(s)
        if bits <= thr:
            return s, bits, nz, [count[k] for k in STAT_NAMES]
    return 64, 0, 0, [count[k] for k in STAT_NAMES]


def select_search_plain(c_abs, thr_ac, seeds=None, groups=1):
    """The search of K1 and K6, evaluation for evaluation (plain torch,
    frame by frame; for tests and measurements, not a wrapper's CPU path).

    c_abs: (B, 63, NB) |coefs|; thr_ac: (B,); seeds: (B,) search seeds or
    None, a seed outside 1..63 meaning none; ``groups``: the scales one
    self-seeding round probes (:func:`search_groups`). Returns
    (scale, ac_bits, nz, stats): the first three equal :func:`_first_fit`
    whatever the seeds; stats (B, 8) int32 counts per frame what the first
    ``COUNT_STATS`` of ``STAT_NAMES`` name: full ladder evaluations, fused
    passes, exact evaluations, self-seeding rounds (the other columns are
    the kernels' own and 0 here). A frame first searches a subsample of
    its blocks for a likely scale, starting at its seed, then checks that
    scale on all of them: a seed that is the answer costs one such round
    and one fused pass, where the ladder rules out the scale below."""
    B = c_abs.shape[0]
    seed_list = [0] * B if seeds is None else [int(s) for s in seeds]
    rows = [_search_frame(c_abs[b], int(thr_ac[b]), seed_list[b], groups)
            for b in range(B)]
    dev = c_abs.device
    scale, bits, nz = (torch.tensor([r[k] for r in rows], dtype=torch.int32,
                                    device=dev) for k in range(3))
    stats = torch.tensor([r[3] for r in rows], dtype=torch.int32, device=dev)
    return scale, bits, nz, stats


def _check_seeds(seeds, batch, device, name):
    """``seeds`` as the kernels take it: None, or a (B,) integer tensor on
    ``device``, returned as contiguous int32. Seeds only order the search
    (a value outside 1..63 means none); they never change an output."""
    if seeds is None:
        return None
    if (not isinstance(seeds, torch.Tensor) or seeds.shape != (batch,)
            or seeds.dtype.is_floating_point or seeds.dtype == torch.bool):
        raise ValueError(f"{name}: seeds must be a (B,) = ({batch},) "
                         "integer tensor")
    if seeds.device != device:
        raise ValueError(f"{name}: seeds are on {seeds.device}, the frames "
                         f"on {device}")
    return seeds.to(torch.int32).contiguous()


def _stats_arg(stats_out, batch, device, name):
    if stats_out is None:
        return None
    _require(stats_out, torch.int32, 2, f"{name} stats_out")
    if stats_out.shape != (batch, len(STAT_NAMES)) \
            or stats_out.device != device:
        raise ValueError(f"{name}: stats_out must be (B, "
                         f"{len(STAT_NAMES)}) on {device}")
    return stats_out


def _opt_ptr(t):
    return _build.ptr(t) if t is not None else None


def select_scale_pix_plain(pix, thr_ac, seeds=None):
    """FDCT + first-fit scale selection (plain torch).

    pix: (B, 64, NB) int8 centered pixel rows; thr_ac: (B,) int32;
    ``seeds`` is ignored (no answer depends on it).
    Returns (scale, ac_bits, nz, coefs): the selection of
    :func:`select_scale_plain` on the FDCT, and the FDCT itself as coefs
    (B, 64, nb_pad) int16 signed zigzag rows, row 63 and the pad lanes
    zero.
    """
    B, P, nb = pix.shape
    c = bs_ops.pixrows_to_coefs_zz(pix)                    # (B, 63, NB)
    coefs = torch.zeros((B, 64, nb_padded(nb)), dtype=torch.int16,
                        device=pix.device)
    coefs[:, :63, :nb] = c.to(torch.int16)
    return (*_first_fit(c.abs(), thr_ac), coefs)


def select_scale_pix(pix, thr_ac, seeds=None, stats_out=None):
    """K1 (``csrc/bs_select.cu``): see :func:`select_scale_pix_plain`.

    ``seeds``: optional (B,) integer tensor on the pixels' device, a guess
    of each frame's scale (a value outside 1..63 means none). It only says
    where the search looks first and changes no output. ``stats_out``: optional
    (B, 8) int32 tensor the kernel fills with its evaluation counts and
    cycles per frame (``STAT_NAMES``); the CPU path zeroes it."""
    seeds = _check_seeds(seeds, pix.shape[0], pix.device, "select_scale_pix")
    stats_out = _stats_arg(stats_out, pix.shape[0], pix.device,
                           "select_scale_pix")
    if not _on_cuda(pix, "select_scale_pix"):
        if stats_out is not None:
            stats_out.zero_()
        return select_scale_pix_plain(pix, thr_ac)
    _require(pix, torch.int8, 3, "select_scale_pix pix")
    B, P, nb = pix.shape
    if P != 64:
        raise ValueError("select_scale_pix: pix must be (B, 64, NB)")
    thr = thr_ac.to(device=pix.device, dtype=torch.int32).contiguous()
    if thr.shape != (B,):
        raise ValueError("select_scale_pix: thr_ac must be (B,)")
    nb_pad = nb_padded(nb)
    scale = torch.empty((B,), dtype=torch.int32, device=pix.device)
    bits = torch.empty_like(scale)
    nz = torch.empty_like(scale)
    coefs = torch.empty((B, 64, nb_pad), dtype=torch.int16, device=pix.device)
    _check_constants()
    LAUNCHES["select_scale_pix"] += 1
    _build.launch("psx_select_scale_pix", pix, _build.ptr(pix),
                  _build.ptr(thr), _opt_ptr(seeds), B, nb, nb_pad, K1_THREADS,
                  _build.ptr(scale), _build.ptr(bits), _build.ptr(nz),
                  _build.ptr(coefs), _opt_ptr(stats_out))
    return scale, bits, nz, coefs


# ------------------------------------------------------------------- K6

def select_scale_plain(c, thr_ac, seeds=None):
    """First-fit scale selection from coefficients (plain torch).

    c: (B, 63, NB) int32 zigzag AC coefficients; thr_ac: (B,) int32 (may
    be negative: then nothing fits); ``seeds`` is ignored (no answer
    depends on it). Returns (scale, ac_bits, nz), each
    (B,) int32: the first s in 1..63 whose exact AC bit total is <= thr_ac
    (64 if none, with ac_bits and nz 0).
    """
    return _first_fit(c.to(torch.int32).abs(), thr_ac)


def select_scale(c, thr_ac, seeds=None, stats_out=None):
    """K6 (``csrc/bs_select.cu``): see :func:`select_scale_plain`; |c| <
    2^17. ``seeds`` and ``stats_out`` as :func:`select_scale_pix`."""
    seeds = _check_seeds(seeds, c.shape[0], c.device, "select_scale")
    stats_out = _stats_arg(stats_out, c.shape[0], c.device, "select_scale")
    if not _on_cuda(c, "select_scale"):
        if stats_out is not None:
            stats_out.zero_()
        return select_scale_plain(c, thr_ac)
    _require(c, torch.int32, 3, "select_scale c")
    B, P, nb = c.shape
    if P != 63:
        raise ValueError("select_scale: c must be (B, 63, NB)")
    thr = thr_ac.to(device=c.device, dtype=torch.int32).contiguous()
    if thr.shape != (B,):
        raise ValueError("select_scale: thr_ac must be (B,)")
    scale = torch.empty((B,), dtype=torch.int32, device=c.device)
    bits = torch.empty_like(scale)
    nz = torch.empty_like(scale)
    _check_constants()
    LAUNCHES["select_scale"] += 1
    _build.launch("psx_select_scale", c, _build.ptr(c), _build.ptr(thr),
                  _opt_ptr(seeds), B, nb, K6_THREADS, _build.ptr(scale),
                  _build.ptr(bits), _build.ptr(nz), _opt_ptr(stats_out))
    return scale, bits, nz


# ------------------------------------------------------------------- K2

def dc_stage_plain(dc_q, codec):
    """v3/v3dc DC chain + DC Huffman (plain torch): (B, NB) clamped
    quantized DCs -> (dc_bits, dc_code) int32."""
    return bs_ops._dc_stage(dc_q, codec)


DC_PARTS = 6  # K2's warps a frame: Cr, Cb and the Y chain in quarters


def _apply(f, x):
    t, a, b, ident = f
    return torch.where(ident, x, torch.where(x < t, a, b))


def _compose(p, q):
    """p, then q, on (t, a, b, identity flag) tensors."""
    pt, pa, pb, pid = p
    qt, qa, qb, qid = q
    t = torch.where(qid, pt, torch.where(pid, qt, pt))
    a = torch.where(qid, pa, torch.where(pid, qa, _apply(q, pa)))
    b = torch.where(qid, pb, torch.where(pid, qb, _apply(q, pb)))
    return t, a, b, pid & qid


def _lanes_up(f, off):
    """f of the lane ``off`` below (``__shfl_up_sync``), the identity for
    the first ``off`` lanes."""
    def shift(x, fill):
        pad = torch.full(x.shape[:-1] + (off,), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([pad, x[..., :-off]], dim=-1)
    t, a, b, ident = f
    return shift(t, 0), shift(a, 0), shift(b, 0), shift(ident, True)


def dc_stage_segmented_plain(dc_q, codec, lanes=32):
    """K2's decomposition step for step (a plain model for the tests;
    nothing on the main path runs it): equal to :func:`dc_stage_plain`.

    Each frame's chains in chain order (Cr, Cb, then the Y chain) are cut
    into ``DC_PARTS`` parts of NB / 6 blocks, a warp each; lane l of a part
    takes its blocks [l * seg, (l + 1) * seg), seg = ceil(NB / 6 / lanes),
    and composes their threshold functions into one (the identity for a
    lane past the part's end). A Hillis-Steele scan over the lanes and a
    shift by one give each lane the composition of the lanes before it;
    the Y quarters start from the earlier quarters' totals applied to 0.
    Each lane then walks its blocks again from its entry ``last``."""
    B, nb = dc_q.shape
    mb = nb // 6
    d = dc_q.to(torch.int32).reshape(B, mb, 6)
    chain = torch.cat([d[:, :, 0], d[:, :, 1], d[:, :, 2:].reshape(B, -1)],
                      dim=1)
    seg = -(-mb // lanes)
    dp = torch.nn.functional.pad(chain.reshape(B, DC_PARTS, mb),
                                 (0, lanes * seg - mb))
    dp = dp.reshape(B, DC_PARTS, lanes, seg)
    live = (torch.arange(lanes * seg, device=d.device) < mb).reshape(
        lanes, seg)
    te, ae, be = bs_ops.dc_steps(dp)

    # Pass 1: each lane's segment composed.
    t, a, b = te[..., 0], ae[..., 0], be[..., 0]
    for j in range(1, seg):
        step = (te[..., j], ae[..., j], be[..., j], ~live[:, j])
        a, b = _apply(step, a), _apply(step, b)
    f = (t, a, b, (~live[:, 0]).expand(t.shape))
    # The scan over the lanes, then the exclusive prefix.
    off = 1
    while off < lanes:
        f = _compose(_lanes_up(f, off), f)
        off *= 2
    before = _lanes_up(f, 1)
    totals = tuple(x[..., -1] for x in f)                     # (B, parts)
    entry = [torch.zeros(B, dtype=torch.int32, device=d.device)] * 3
    for p in range(3, DC_PARTS):
        entry.append(_apply(tuple(x[:, p - 1] for x in totals),
                            entry[p - 1]))
    last = _apply(before, torch.stack(entry, dim=1)[..., None])

    # Pass 2: the deltas.
    deltas = torch.zeros_like(dp)
    for j in range(seg):
        nxt = _apply((te[..., j], ae[..., j], be[..., j], ~live[:, j]), last)
        deltas[..., j] = (nxt - last) >> 2
        last = nxt
    deltas = deltas.reshape(B, DC_PARTS * lanes * seg)
    deltas = deltas.reshape(B, DC_PARTS, -1)[:, :, :mb]
    deltas = torch.cat([deltas[:, 0, :, None], deltas[:, 1, :, None],
                        deltas[:, 2:].reshape(B, mb, 4)], dim=2).reshape(
        B, nb)
    if codec == bs_ops.BS_V3DC:
        deltas = torch.where(deltas < -0x80, deltas + 0x100, deltas)
        deltas = torch.where(deltas > 0x80, deltas - 0x100, deltas)
    types = (torch.arange(nb, dtype=torch.int32, device=d.device)
             % 6).clamp(max=2)
    bits, code = bs_ops.dc_bits_code_closed_form(types[None, :],
                                                 deltas & 0x1FF)
    return bits.to(torch.int32), code.to(torch.int32)


def dc_stage(dc_q, codec):
    """K2 (``csrc/bs_dc.cu``): see :func:`dc_stage_plain`; v3/v3dc only."""
    if codec not in (bs_ops.BS_V3, bs_ops.BS_V3DC):
        raise ValueError("dc_stage: codec must be BS_V3 or BS_V3DC")
    if not _on_cuda(dc_q, "dc_stage"):
        return dc_stage_plain(dc_q, codec)
    dc_q = dc_q.to(torch.int32).contiguous()
    B, nb = dc_q.shape
    if nb % 6:
        raise ValueError("dc_stage: NB must be a multiple of 6")
    bits = torch.empty_like(dc_q)
    code = torch.empty_like(dc_q)
    LAUNCHES["dc_stage"] += 1
    _build.launch("psx_dc_stage", dc_q, _build.ptr(dc_q), B, nb,
                  int(codec == bs_ops.BS_V3DC), _build.ptr(bits),
                  _build.ptr(code))
    return bits, code


def empty_launch(t, grid=1, threads=32):
    """Launches an empty kernel of ``grid`` CTAs on ``t``'s CUDA device:
    the floor of a launch, against which the short kernels' times are
    read."""
    _build.launch("psx_empty_launch", t, grid, threads)


# ------------------------------------------------------------------- K3

def _place(acc, o, b, c):
    """OR (B, NB) codes ``c`` of ``b`` bits at in-block offsets ``o`` into
    the (B, 8, NB) MSB-first u32 windows ``acc`` (int64)."""
    q = (o >> 5)[:, None, :]
    sbits = 64 - (o & 31) - b
    mask = bitpack_ops.U32_MASK
    sh = (sbits - 32).clamp(0, 31)
    sl = (32 - sbits).clamp(0, 31)
    hi = torch.where(sbits >= 32, torch.bitwise_left_shift(c, sh) & mask,
                     c >> sl)
    lo = torch.where(sbits < 32,
                     torch.bitwise_left_shift(c, sbits.clamp(0, 31)) & mask,
                     0)
    row = torch.arange(8, device=acc.device)[None, :, None]
    return (acc | torch.where(row == q, hi[:, None, :], 0)
            | torch.where(row == q + 1, lo[:, None, :], 0))


def _emit_windows(coefs, scale, dc_code, dc_bits):
    """Per-block emission at the frame's scale (plain torch): DC, the
    nonzero ACs' codes and EOB placed into (B, 8, NB) int64 MSB-first u32
    windows; returns (windows, block_bits (B, NB) int64 including DC and
    EOB). Bits past the 256th are cut; callers gate on block_bits.

    coefs: (B, 64, nb_pad) int16 select-kernel coefficients or (B, 63, NB)
    int32 zigzag AC coefficients; the true NB is the width of dc_code.
    """
    B = coefs.shape[0]
    nb = dc_code.shape[1]
    dev = coefs.device
    c = coefs[:, :63, :nb].to(torch.int32)
    qs = (bs_ops.quant_zz(dev)[None, :]
          * scale.to(device=dev, dtype=torch.int32)[:, None])[:, :, None]
    mag = bs_ops._div_rounded_fast(c.abs(), qs.expand_as(c))
    ac = torch.where(c < 0, -mag, mag).clamp(-0x200, 0x1FE)
    nz = ac != 0
    run = bs_ops._runs(nz, 1)
    bits_nz, code_nz = bs_ops.ac_bits_code_closed_form(run, ac)
    bits = torch.where(nz, bits_nz, 0).to(torch.int64)
    code = torch.where(nz, code_nz, 0).to(torch.int64)

    dcb = dc_bits.to(torch.int64)
    offs = dcb[:, None, :] + torch.cumsum(bits, dim=1) - bits  # (B, 63, NB)
    total = offs[:, 62] + bits[:, 62]
    acc = torch.zeros((B, 8, nb), dtype=torch.int64, device=dev)
    acc = _place(acc, torch.zeros_like(dcb), dcb, dc_code.to(torch.int64))
    for i in range(63):
        acc = _place(acc, offs[:, i], bits[:, i], code[:, i])
    two = torch.full_like(total, 2)
    acc = _place(acc, total, two, two)                 # EOB
    return acc, total + 2


def emit_prep_plain(coefs, scale, dc_code, dc_bits, *, eof):
    """Winner emission + per-block packing + placement prep (plain torch).

    coefs: (B, 64, nb_pad) int16 select-kernel coefficients; scale (B,) in
    1..63; dc_code/dc_bits (B, NB). Returns (vals32 (B, NB+1, 9) int32 u32
    bit patterns, e0 (B, NB+1) int32, block_bits (B, NB) int32,
    total_bits (B,) int32), the EOF block at index NB. Blocks over 256
    bits are cut; callers gate on block_bits.
    """
    streams, block_bits = emit_pack_plain(coefs, scale, dc_code, dc_bits)
    streams, bb = bitpack_ops.with_eof_block(streams, block_bits, eof)
    goff = torch.cumsum(bb, dim=1) - bb
    vals32, e0 = bitpack_ops.streams_to_u32(streams, goff)
    return (bitpack_ops.u32_to_i32(vals32), e0.to(torch.int32), block_bits,
            bb.sum(dim=1).to(torch.int32))


def _emit_args(coefs, scale, dc_code, dc_bits, name):
    """Checks the emission kernels' inputs; returns scale, dc_code and
    dc_bits as contiguous int32 on the coefficients' device."""
    B = coefs.shape[0]
    nb = dc_code.shape[1]
    if nb > coefs.shape[2]:
        raise ValueError(f"{name}: coefs are narrower than NB")
    dev = coefs.device
    scale = scale.to(device=dev, dtype=torch.int32).contiguous()
    dc_code = dc_code.to(device=dev, dtype=torch.int32).contiguous()
    dc_bits = dc_bits.to(device=dev, dtype=torch.int32).contiguous()
    if scale.shape != (B,) or dc_code.shape != (B, nb) \
            or dc_bits.shape != (B, nb):
        raise ValueError(f"{name}: expected scale (B,) and dc_code, "
                         "dc_bits (B, NB)")
    return scale, dc_code, dc_bits


EMIT_MAX_THREADS = 960     # ten groups of EMIT_GROUP
EMIT_GROUP = 96            # whole warps that hold each of a macroblock's six
                           # kinds of block equally often
# K3's statistics per frame, SM cycles on the clock of the CTA's last warp
# (a warp of luma blocks, whose lanes meet around each pass): starting the
# first tile's copy and loading the tables; its own blocks' find and walk
# passes; the CTA's whole emission (tiles, passes, parking); the scan; the
# shift and store; and, inside the emission, its waits for the trips' tiles
# and for the trips' slowest warps. The CTA's whole time is columns 0, 3, 4
# and 5 together.
EMIT_STAT_NAMES = ("tables_cycles", "find_cycles", "walk_cycles",
                   "emit_cycles", "scan_cycles", "store_cycles",
                   "tile_wait_cycles", "warp_wait_cycles")


def emit_threads(nb):
    """K3's CTA width for a frame of ``nb`` blocks: the blocks spread
    evenly over as few trips as EMIT_MAX_THREADS allow, in whole groups
    of EMIT_GROUP."""
    trips = max(1, -(-nb // EMIT_MAX_THREADS))
    per_trip = -(-nb // trips)
    return max(EMIT_GROUP, -(-per_trip // EMIT_GROUP) * EMIT_GROUP)


def emit_prep(coefs, scale, dc_code, dc_bits, *, eof, stats_out=None):
    """K3 (``csrc/bs_emit.cu``): see :func:`emit_prep_plain`.
    ``stats_out``: optional (B, 8) int32 tensor the kernel fills with its
    sections' cycles per frame (``EMIT_STAT_NAMES``); the CPU path zeroes
    it."""
    if stats_out is not None:
        _require(stats_out, torch.int32, 2, "emit_prep stats_out")
        if stats_out.shape != (coefs.shape[0], len(EMIT_STAT_NAMES)) \
                or stats_out.device != coefs.device:
            raise ValueError(f"emit_prep: stats_out must be (B, "
                             f"{len(EMIT_STAT_NAMES)}) on {coefs.device}")
    if not _on_cuda(coefs, "emit_prep"):
        if stats_out is not None:
            stats_out.zero_()
        return emit_prep_plain(coefs, scale, dc_code, dc_bits, eof=eof)
    _require(coefs, torch.int16, 3, "emit_prep coefs")
    B, P, nb_pad = coefs.shape
    if P != 64 or nb_pad % 8 or coefs.data_ptr() % 16:
        raise ValueError("emit_prep: coefs must be (B, 64, nb_pad) with "
                         "nb_pad a multiple of 8, 16-byte aligned")
    scale, dc_code, dc_bits = _emit_args(coefs, scale, dc_code, dc_bits,
                                         "emit_prep")
    nb = dc_code.shape[1]
    dev = coefs.device
    vals32 = torch.empty((B, nb + 1, 9), dtype=torch.int32, device=dev)
    e0 = torch.empty((B, nb + 1), dtype=torch.int32, device=dev)
    block_bits = torch.empty((B, nb), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    LAUNCHES["emit_prep"] += 1
    _build.launch("psx_emit_prep", coefs, _build.ptr(coefs), B, nb_pad, nb,
                  _build.ptr(scale), _build.ptr(dc_code), _build.ptr(dc_bits),
                  int(eof), emit_threads(nb), _build.ptr(vals32),
                  _build.ptr(e0), _build.ptr(block_bits), _build.ptr(total),
                  _opt_ptr(stats_out))
    return vals32, e0, block_bits, total


# ------------------------------------------------------------------- K7

def emit_pack_plain(coefs, scale, dc_code, dc_bits):
    """Winner emission + per-block packing (plain torch).

    coefs: (B, 64, nb_pad) int16 select-kernel coefficients (row 63 and
    the pad lanes are ignored) or (B, 63, NB) int32 zigzag AC
    coefficients; scale (B,) in 1..63; dc_code/dc_bits (B, NB), whose
    width is the true NB. Returns (streams (B, NB, 16) int32 u16 values,
    word 2k = window k >> 16 and word 2k+1 = window k & 0xFFFF;
    block_bits (B, NB) int32: DC + ACs + EOB). Blocks over 256 bits are
    cut; callers gate on block_bits.
    """
    acc, block_bits = _emit_windows(coefs, scale, dc_code, dc_bits)
    B, _, nb = acc.shape
    streams = torch.stack([acc >> 16, acc & 0xFFFF], dim=2).reshape(
        B, 16, nb).transpose(1, 2)
    return streams.to(torch.int32).contiguous(), block_bits.to(torch.int32)


def emit_pack(coefs, scale, dc_code, dc_bits):
    """K7 (``csrc/bs_emit.cu``): see :func:`emit_pack_plain`."""
    if not _on_cuda(coefs, "emit_pack"):
        return emit_pack_plain(coefs, scale, dc_code, dc_bits)
    int16_form = _coef_form(coefs, "emit_pack")
    scale, dc_code, dc_bits = _emit_args(coefs, scale, dc_code, dc_bits,
                                         "emit_pack")
    B, rows, stride = coefs.shape
    nb = dc_code.shape[1]
    streams = torch.empty((B, nb, 16), dtype=torch.int32, device=coefs.device)
    block_bits = torch.empty((B, nb), dtype=torch.int32, device=coefs.device)
    LAUNCHES["emit_pack"] += 1
    _build.launch("psx_emit_pack", coefs, _build.ptr(coefs),
                  int16_form, B, rows, stride, nb,
                  _build.ptr(scale), _build.ptr(dc_code), _build.ptr(dc_bits),
                  _build.ptr(streams), _build.ptr(block_bits))
    return streams, block_bits


# ------------------------------------------------- the tail emission

WINDOW_BITS = 16 * bitpack_ops.BLOCK_CAP_WORDS


def _coef_form(coefs, name):
    """Checks an emission kernel's coefficient form; returns 1 for
    (B, 64, nb_pad) int16, 0 for (B, 63, NB) int32."""
    form = (coefs.dtype, coefs.shape[1] if coefs.ndim == 3 else None)
    if form not in ((torch.int16, 64), (torch.int32, 63)):
        raise ValueError(f"{name}: coefs must be (B, 64, nb_pad) int16 or "
                         f"(B, 63, NB) int32, got {coefs.dtype} "
                         f"{tuple(coefs.shape)}")
    _require(coefs, coefs.dtype, 3, f"{name} coefs")
    return int(coefs.dtype == torch.int16)


def _tail_args(out32, block_bits, dc_code, capacity_words, count, name):
    B, nb = dc_code.shape
    cap32 = bitpack_ops.cap32_of(capacity_words)
    _require(out32, torch.int32, 2, f"{name} out32")
    _require(block_bits, torch.int32, 2, f"{name} block_bits")
    if out32.shape != (B, cap32) or block_bits.shape != (B, nb) \
            or block_bits.device != out32.device:
        raise ValueError(f"{name}: expected out32 (B, {cap32}) and "
                         "block_bits (B, NB) on one device")
    if count is None:
        return torch.zeros((1,), dtype=torch.int32, device=out32.device)
    _require(count, torch.int32, 1, f"{name} count")
    if count.shape != (1,) or count.device != out32.device:
        raise ValueError(f"{name}: count must be (1,) on {out32.device}")
    return count


def emit_tail_plain(out32, coefs, scale, dc_code, dc_bits, block_bits, *,
                    capacity_words, count=None):
    """The tail emission (plain torch): the bits at or past in-block bit
    256 of every block whose ``block_bits`` is over 256, ORed into the
    placed words at the block's frame-global bit offset (the exclusive
    sum of ``block_bits``), as the exact flat packer lays them.

    out32: (B, cap32) int32 placed u32 words (K4's or K8's output, which
    holds every block's first 256 bits); coefs, scale, dc_code, dc_bits:
    the emission's inputs, either coefficient form; block_bits: (B, NB)
    int32 uncut block totals (K3's or K7's). u16 words at or past
    ``capacity_words`` drop. Returns (the words, a new tensor; ``count``,
    a (1,) int32 tensor on the words' device or a new zero if None, with
    the number of frames that have such a block added in place)."""
    count = _tail_args(out32, block_bits, dc_code, capacity_words, count,
                       "emit_tail")
    B, nb = dc_code.shape
    c = coefs[:, :63, :nb].to(torch.int32)
    codes, bits = bs_ops.emit_symbols_at(
        c, scale.to(device=c.device, dtype=torch.int32) - 1, dc_bits,
        dc_code)
    end = torch.cumsum(bits, dim=2)                  # in-block end offsets
    keep = (end - WINDOW_BITS).clamp(min=0).minimum(bits)
    codes = codes & (torch.bitwise_left_shift(torch.ones_like(keep), keep)
                     - 1)
    bb = block_bits.to(torch.int64)
    goff = torch.cumsum(bb, dim=1) - bb
    at = goff[:, :, None] + end - keep
    words = bitpack_ops.pack_bits_at(
        codes.reshape(B, -1), keep.reshape(B, -1), at.reshape(B, -1),
        capacity_words=capacity_words)
    pad = 2 * out32.shape[1] - capacity_words
    pairs = torch.nn.functional.pad(words, (0, pad)).reshape(B, -1, 2)
    tail32 = bitpack_ops.u32_to_i32(pairs[..., 0] | (pairs[..., 1] << 16))
    count += (block_bits > WINDOW_BITS).any(dim=1).sum(dtype=torch.int32)
    return out32 | tail32, count


TAIL_WARPS = 16           # warps of a CTA of the tail emission
TAIL_MAX_CTAS = 8         # CTAs a frame, at most
AC_LOW = 7 * 32           # csrc/ac_codes.cuh: levels 1..7 at runs 0..31,
AC_HIGH = 2 * 33          # then runs 0 and 1 at levels 8..40


def tail_ctas(batch, sms):
    """CTAs a frame of the tail emission: about four CTAs an SM over the
    batch (``sms`` SMs), between 1 and TAIL_MAX_CTAS."""
    return min(TAIL_MAX_CTAS, max(1, -(-4 * sms // max(batch, 1))))


def emit_tail_grid(batch, sms=None):
    """The tail emission's launch on the current CUDA device (or one of
    ``sms`` SMs): (CTAs, threads a CTA)."""
    sms = sm_count("cuda") if sms is None else sms
    return batch * tail_ctas(batch, sms), 32 * TAIL_WARPS


def ac_code_table(device=None):
    """The AC code table that csrc/ac_codes.cuh holds, from the closed form
    (ops/bs.py): (AC_LOW + AC_HIGH,) int64 entries (bits << 24) | the code
    of the positive level, 0 for the 22-bit escape; index (level - 1) * 32
    + run for levels 1..7 at runs 0..31, AC_LOW + run * 33 + level - 8 for
    runs 0 and 1 at levels 8..40."""
    i = torch.arange(AC_LOW + AC_HIGH, device=device)
    j = i - AC_LOW
    run = torch.where(i < AC_LOW, i & 31, j // 33)
    level = torch.where(i < AC_LOW, (i >> 5) + 1, j % 33 + 8)
    bits, code = bs_ops.ac_bits_code_closed_form(run, level)
    return torch.where(bits == 22, 0, (bits.to(torch.int64) << 24)
                       | code.to(torch.int64))


def _table_code(table, run, ac):
    """(bits, code) of nonzero levels ``ac`` at runs ``run`` as the tail
    emission looks them up (``table_code`` in csrc/bs_emit.cu)."""
    a = ac.abs()
    low = a <= 7
    listed = torch.where(low, run < 32, (a <= 40) & (run < 2))
    at = torch.where(low, ((a - 1) << 5) + run, AC_LOW + run * 33 + a - 8)
    e = torch.where(listed, table[at.clamp(0, AC_LOW + AC_HIGH - 1)], 0)
    sign = (ac < 0).to(torch.int64)
    escape = (1 << 16) | (run << 10) | (ac & 0x3FF)
    return (torch.where(e != 0, e >> 24, 22),
            torch.where(e != 0, (e & 0xFFFFFF) | sign, escape))


def _msb(x):
    """The index of the highest set bit of each non-negative int64 below
    2^32, -1 for 0 (the kernel's 31 - __clz)."""
    r = torch.zeros_like(x)
    for step in (16, 8, 4, 2, 1):
        up = (x >> (r + step)) != 0
        r = r + step * up.to(x.dtype)
    return torch.where(x > 0, r, -1)


def _tail_words(g, end, bits, code, on, capacity_words):
    """The kernel's ``or_tail`` for codes that end at in-block bit ``end``
    of blocks at frame bit ``g`` (all int64, one shape; ``on`` marks the
    codes that exist): (word index, u32 value) pairs of the two u32 words
    each code's last min(end - 256, bits) bits touch, value 0 where none."""
    keep = torch.minimum(end - WINDOW_BITS, bits)
    on = on & (keep > 0)
    keep = keep.clamp(1, 31)
    p = g + end - keep
    k = p >> 4
    one = torch.ones_like(keep)
    t = (code & (torch.bitwise_left_shift(one, keep) - 1)) \
        << (48 - (p & 15) - keep)
    pairs = torch.zeros_like(t)
    for i in range(3):
        half = (t >> (32 - 16 * i)) & 0xFFFF
        pairs |= torch.where(k + i < capacity_words, half, 0) << (16 * i)
    pairs = torch.where(on, pairs, 0)
    lo = (pairs << (16 * (k & 1))) & bitpack_ops.U32_MASK
    hi = (pairs << (16 * (k & 1))) >> 32
    word = (k >> 1).clamp(min=0)
    return torch.stack([word, word + 1]), torch.stack([lo, hi])


def _lane_scan(x):
    """Inclusive scan over the last axis (32 lanes) in five Hillis-Steele
    steps, as a warp's __shfl_up_sync scan."""
    off = 1
    while off < 32:
        x = x + torch.nn.functional.pad(x[..., :-off], (off, 0))
        off *= 2
    return x


def emit_tail_lanes_plain(out32, coefs, scale, dc_code, dc_bits, block_bits,
                          *, capacity_words, count=None, ctas=1,
                          warps=TAIL_WARPS):
    """The tail emission's decomposition (a plain model for the tests;
    nothing on the main path runs it): equal to :func:`emit_tail_plain`.

    A frame's long blocks (over 256 bits), ranked in block order, go to
    its ``ctas`` x ``warps`` warps: rank q to CTA (q mod (ctas * warps))
    // warps; CTA 0 counts the frame. Each CTA's blocks are emitted apart,
    a warp a block: lane l holds scan positions l and l + 32 (63: none);
    two ballots give the nonzero mask, each run is the lane's position
    less the highest set bit below it, less one; codes come from the
    table (:func:`ac_code_table`) or the escape; one scan of the two
    lengths packed as bits_a | bits_b << 16 gives each code's end, after
    the DC code; the EOB ends at the block's total. Each code's part past
    bit 256 is ORed into at most two u32 words (u16 words at or past
    ``capacity_words`` drop); a block whose offset + 256 reaches the
    capacity is skipped whole."""
    count = _tail_args(out32, block_bits, dc_code, capacity_words, count,
                       "emit_tail")
    B, nb = dc_code.shape
    dev = out32.device
    table = ac_code_table(dev)
    out = out32.to(torch.int64) & bitpack_ops.U32_MASK
    bb = block_bits.to(torch.int64)
    goff = torch.cumsum(bb, dim=1) - bb
    lane = torch.arange(32, device=dev)
    pos = torch.stack([lane, lane + 32])                       # (2, 32)
    quant = torch.cat([bs_ops.quant_zz(dev).to(torch.int64),
                       torch.ones(1, dtype=torch.int64, device=dev)])
    for b in range(B):
        ranks = torch.nonzero(bb[b] > WINDOW_BITS)[:, 0]
        if not ranks.numel():
            continue
        d = quant[pos] * int(scale[b])
        thr = torch.where(pos < 63, (d + 1) >> 1, 2 ** 31 - 1)
        c64 = torch.cat([coefs[b, :63, :nb].to(torch.int64),
                         torch.zeros((1, nb), dtype=torch.int64,
                                     device=dev)])
        cta = (torch.arange(ranks.numel(), device=dev)
               % (ctas * warps)) // warps
        count += 1                          # by CTA 0, once for the frame
        for part in range(ctas):
            n = ranks[cta == part]
            g = goff[b, n][:, None, None]
            dcb = dc_bits[b, n].to(torch.int64)[:, None, None]
            c = c64[pos][:, :, n].permute(2, 0, 1)             # (N, 2, 32)
            nz = c.abs() >= thr
            masks = (nz.to(torch.int64) << lane).sum(dim=2)    # (N, 2)
            below = torch.bitwise_left_shift(torch.ones_like(lane), lane) - 1
            prev_a = _msb(masks[:, :1] & below)
            prev_hi = _msb(masks[:, 1:] & below)
            prev_b = torch.where(prev_hi >= 0, 32 + prev_hi,
                                 _msb(masks[:, :1]))
            run = torch.stack([lane - prev_a - 1, lane + 31 - prev_b], 1)
            mag = torch.div(c.abs() + (d >> 1), d, rounding_mode="floor")
            ac = torch.where(c < 0, -mag, mag).clamp(-0x200, 0x1FE)
            bits, code = _table_code(table, run.clamp(min=0), ac)
            bits = torch.where(nz, bits, 0)
            x = _lane_scan(bits[:, 0] | (bits[:, 1] << 16))    # (N, 32)
            all_ = x[:, 31:]
            half = dcb[:, 0] + (all_ & 0xFFFF)
            end = torch.stack([dcb[:, 0] + (x & 0xFFFF), half + (x >> 16)],
                              1)
            eob = (half + (all_ >> 16) + 2)[:, None]           # (N, 1, 1)
            on = (g + WINDOW_BITS < capacity_words * 16)
            words, vals = _tail_words(g, end, bits, code, nz & on,
                                      capacity_words)
            eob_words, eob_vals = _tail_words(
                g, eob, torch.full_like(eob, 2), torch.full_like(eob, 2),
                on, capacity_words)
            idx = torch.cat([words.reshape(-1), eob_words.reshape(-1)])
            val = torch.cat([vals.reshape(-1), eob_vals.reshape(-1)])
            hit = val != 0
            out[b] |= bitpack_ops.or_scatter(out.shape[1], idx[hit], val[hit])
    return bitpack_ops.u32_to_i32(out), count


def emit_tail(out32, coefs, scale, dc_code, dc_bits, block_bits, *,
              capacity_words, count=None):
    """The tail emission (``csrc/bs_emit.cu``): see
    :func:`emit_tail_plain`. On the card ``out32`` is updated in place and
    returned, and ``count`` (a (1,) int32 tensor on the same device; a new
    zero if None) is added to in place and returned: nothing waits for the
    device."""
    if not _on_cuda(out32, "emit_tail"):
        return emit_tail_plain(out32, coefs, scale, dc_code, dc_bits,
                               block_bits, capacity_words=capacity_words,
                               count=count)
    int16_form = _coef_form(coefs, "emit_tail")
    if coefs.device != out32.device:
        raise ValueError("emit_tail: coefs and out32 are on two devices")
    scale, dc_code, dc_bits = _emit_args(coefs, scale, dc_code, dc_bits,
                                         "emit_tail")
    count = _tail_args(out32, block_bits, dc_code, capacity_words, count,
                       "emit_tail")
    B, rows, stride = coefs.shape
    nb = dc_code.shape[1]
    ctas = tail_ctas(B, sm_count(out32.device))
    if B * ctas >= 2 ** 31 or B * max(nb, out32.shape[1]) >= 2 ** 31:
        raise ValueError("emit_tail: the batch is too large for the "
                         "kernel's 32-bit indices")
    LAUNCHES["emit_tail"] += 1
    _build.launch("psx_emit_tail", coefs, _build.ptr(coefs), int16_form, B,
                  rows, stride, nb, _build.ptr(scale), _build.ptr(dc_bits),
                  _build.ptr(block_bits), ctas, out32.shape[1],
                  int(capacity_words), _build.ptr(out32), _build.ptr(count))
    return out32, count
