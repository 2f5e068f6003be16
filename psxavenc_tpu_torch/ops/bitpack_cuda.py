"""Wrappers and plain versions of the placement and packing kernels K4,
K8, K9 and K10.

Counterparts in ``psxavenc_tpu/ops/bitpack_pallas.py``:

- K4 ``place_vals_mxu_pallas``: each frame's bitstream is the OR (equal to
  the sum) of its blocks' bit-disjoint nine-word u32 contributions at u32
  offsets ``e0``, cut to capacity (``csrc/bitpack_place.cu``);
- K8 ``place_vals_gather_pallas``: K4's function as a gather, each output
  word computed from the records that reach it (``csrc/bitpack_gather.cu``);
- K9 ``place_streams_pallas``: the same placement from per-block u16
  streams and their global bit offsets (``csrc/bitpack_streams.cu``);
- K10 ``pack_block_streams_pallas``: dense per-block packing of symbol
  tensors into 16-word streams (``csrc/bitpack_streams.cu``);
- ``place_streams_mxu_u32``: ``streams_to_u32`` glue followed by K4 or K8
  (as ``place_streams_mxu_pallas`` and ``place_streams_gather_pallas``
  are), and ``place_streams_mxu``, its u16 values with the JAX signature.

K4, K8 and K9 give a CTA a range of a frame's output words; the search,
the staging and the range's store are shared (``csrc/place_common.cuh``).

Each wrapper takes the plain version only for CPU tensors and launches its
kernel for CUDA tensors; ``LAUNCHES`` counts the launches.
"""

import torch

from . import _build, bitpack
from .bs_cuda import _on_cuda, _opt_ptr, _require, sm_count

LAUNCHES = {"place_vals": 0, "place_vals_gather": 0, "place_streams": 0,
            "pack_block_streams": 0}

BCAP = bitpack.BLOCK_CAP_WORDS
cap32_of = bitpack.cap32_of


# ------------------------------------------------------------------- K4

def place_vals_plain(vals32, e0, *, capacity_words):
    """(B, NBe, 9) int32 u32 contributions + (B, NBe) offsets -> (B, cap32)
    int32 placed u32 words (plain torch scatter-add into a spare column
    that collects the dropped writes)."""
    B, nbe, _ = vals32.shape
    cap32 = cap32_of(capacity_words)
    v = vals32.to(torch.int64) & bitpack.U32_MASK
    idx = e0.to(torch.int64)[:, :, None] + torch.arange(
        9, device=vals32.device)
    idx = torch.where((idx >= 0) & (idx < cap32), idx, cap32)
    out = torch.zeros((B, cap32 + 1), dtype=torch.int64,
                      device=vals32.device)
    out.scatter_add_(1, idx.reshape(B, -1), v.reshape(B, -1))
    return bitpack.u32_to_i32(out[:, :cap32])


def _check_place_args(vals32, e0, name):
    _require(vals32, torch.int32, 3, f"{name} vals32")
    _require(e0, torch.int32, 2, f"{name} e0")
    B, nbe, slots = vals32.shape
    if slots != 9 or e0.shape != (B, nbe) or e0.device != vals32.device:
        raise ValueError(f"{name}: expected vals32 (B, NBe, 9) and e0 "
                         "(B, NBe) on one device")
    return B, nbe


PLACE_THREADS = 256          # the CTA width of K4, K8 and K9
PLACE_RANGE_MIN = 64         # words a CTA owns, at least
PLACE_RANGE_MAX = 4096       # and at most (its image in shared memory)
PLACE_CHUNK = 512            # blocks K4, K8 and K9 stage at a time


def place_range_words(batch, capacity_words, sms):
    """Words of a frame's output that one CTA of K4 (and of K9) owns:
    ranges enough for about four CTAs an SM over the batch (``sms`` SMs),
    each a multiple of 4 words between PLACE_RANGE_MIN and
    PLACE_RANGE_MAX."""
    cap32 = cap32_of(capacity_words)
    ranges = max(1, -(-4 * sms // max(batch, 1)))
    words = min(max(-(-cap32 // ranges), PLACE_RANGE_MIN), PLACE_RANGE_MAX)
    return -(-words // 4) * 4


def place_vals_grid(batch, capacity_words, sms=None):
    """K4's launch on the current CUDA device (or one of ``sms`` SMs):
    (CTAs, threads a CTA), a CTA per range of a frame's words."""
    sms = sm_count("cuda") if sms is None else sms
    words = place_range_words(batch, capacity_words, sms)
    return batch * -(-cap32_of(capacity_words) // words), PLACE_THREADS


def place_vals(vals32, e0, *, capacity_words):
    """K4 (``csrc/bitpack_place.cu``): see :func:`place_vals_plain`.
    Precondition: each frame's ``e0`` row is non-decreasing (K3's offsets
    and a cumsum of block bits are); the kernel searches it. Each output
    word is written once, so the output is not zero-filled first."""
    if not _on_cuda(vals32, "place_vals"):
        return place_vals_plain(vals32, e0, capacity_words=capacity_words)
    B, nbe = _check_place_args(vals32, e0, "place_vals")
    cap32 = cap32_of(capacity_words)
    if B * nbe * 9 >= 2 ** 31 or B * cap32 >= 2 ** 31:
        raise ValueError("place_vals: the batch is too large for the "
                         "kernel's 32-bit indices")
    words = place_range_words(B, capacity_words, sm_count(vals32.device))
    out = torch.empty((B, cap32), dtype=torch.int32, device=vals32.device)
    LAUNCHES["place_vals"] += 1
    _build.launch("psx_place_vals", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, words, _build.ptr(out))
    return out


def cta_lower_bound_plain(row, key, threads=PLACE_THREADS):
    """The search of K4, K8 and K9 (``cta_lower_bounds`` in
    csrc/place_common.cuh), round by round, for one key: the first index
    of the non-decreasing 1-D ``row`` whose entry is >= ``key`` (its
    length if none). Returns
    (index, rounds). A round cuts the bracket into ``threads`` segments
    and counts those whose last entry is below the key."""
    lo, hi = 0, row.shape[0]
    t = torch.arange(threads, device=row.device)
    rounds = 0
    while lo < hi:
        step = -(-(hi - lo) // threads)
        first = lo + t * step
        last = (first + step).clamp(max=hi) - 1
        below = (first < hi) & (row[last.clamp(0, hi - 1)] < key)
        nxt = lo + int(below.sum()) * step
        if nxt >= hi:
            lo = hi
        else:
            lo, hi = nxt, min(nxt + step, hi) - 1
        rounds += 1
    return lo, rounds


def place_vals_ranges_plain(vals32, e0, *, capacity_words, range_words,
                            threads=PLACE_THREADS):
    """K4's decomposition (a plain model for the tests; nothing on the
    main path runs it): equal to :func:`place_vals_plain` where each
    frame's ``e0`` row is non-decreasing.

    A frame's (cap32,) words are cut into ranges of ``range_words`` words
    (the last may be shorter). Each range is computed alone: the blocks
    with start - 8 <= e0 < end, found by :func:`cta_lower_bound_plain`,
    OR their slots that land in the range into a zeroed image; the images
    are concatenated. Words at or past cap32 lie in no range."""
    B, nbe, _ = vals32.shape
    cap32 = cap32_of(capacity_words)
    v = vals32.to(torch.int64) & bitpack.U32_MASK
    e = e0.to(torch.int64)
    slot = torch.arange(9, device=vals32.device)
    rows = []
    for b in range(B):
        images = []
        for start in range(0, cap32, range_words):
            n = min(range_words, cap32 - start)
            lo, _ = cta_lower_bound_plain(e[b], start - 8, threads)
            hi, _ = cta_lower_bound_plain(e[b], start + n, threads)
            w = (e[b, lo:hi, None] + slot - start).reshape(-1)
            x = v[b, lo:hi].reshape(-1)
            keep = (w >= 0) & (w < n) & (x != 0)
            images.append(bitpack.or_scatter(n, w[keep], x[keep]))
        rows.append(torch.cat(images))
    return bitpack.u32_to_i32(torch.stack(rows))


def place_streams_mxu_u32(streams, goff, *, capacity_words,
                          place=place_vals):
    """Placement of (B, NBe, 16) u16 streams at (B, NBe) global bit
    offsets through K4 (``place``: K4's wrapper, K8's, or a plain
    version): -> (B, cap32) int32 placed u32 words."""
    vals32, e0 = bitpack.streams_to_u32(streams, goff)
    return place(bitpack.u32_to_i32(vals32), e0.to(torch.int32),
                 capacity_words=capacity_words)


def place_streams_mxu(streams, goff, total_bits, *, capacity_words,
                      place=place_vals):
    """:func:`place_streams_mxu_u32` -> (B, capacity_words) int32 u16
    values. ``total_bits`` is taken for the JAX signature; the offsets say
    everything."""
    return bitpack.u16_values(
        place_streams_mxu_u32(streams, goff, capacity_words=capacity_words,
                              place=place), capacity_words)


# ------------------------------------------------------------------- K8

def place_vals_gather_plain(vals32, e0, *, capacity_words):
    """K8's plain version: K4's function, so :func:`place_vals_plain`'s
    scatter-add."""
    return place_vals_plain(vals32, e0, capacity_words=capacity_words)


GATHER_RANGE_MAX = 4 * PLACE_THREADS - 4   # K8: four words a thread, any
                                           # alignment


def gather_range_words(batch, capacity_words, sms):
    """Words of a frame's output that one CTA of K8 owns: K4's ranges
    (:func:`place_range_words`), at most GATHER_RANGE_MAX, so that its 256
    threads of four words cover a range at any offset from a 16-byte
    boundary."""
    return min(place_range_words(batch, capacity_words, sms),
               GATHER_RANGE_MAX)


def place_vals_gather_grid(batch, capacity_words, sms=None):
    """K8's launch on the current CUDA device (or one of ``sms`` SMs):
    (CTAs, threads a CTA), a CTA per range of a frame's words."""
    sms = sm_count("cuda") if sms is None else sms
    words = gather_range_words(batch, capacity_words, sms)
    return batch * -(-cap32_of(capacity_words) // words), PLACE_THREADS


def place_vals_gather(vals32, e0, *, capacity_words):
    """K8 (``csrc/bitpack_gather.cu``): (B, NBe, 9) int32 u32 contributions
    + (B, NBe) int32 u32 offsets -> (B, cap32) int32 placed u32 words, as
    :func:`place_vals_plain`. Precondition: each frame's ``e0`` row is
    non-decreasing (``emit_prep``'s offsets and a cumsum of block bits
    are); the kernel searches it. Each output word is written once, so the
    output is not zero-filled first."""
    if not _on_cuda(vals32, "place_vals_gather"):
        return place_vals_gather_plain(vals32, e0,
                                       capacity_words=capacity_words)
    B, nbe = _check_place_args(vals32, e0, "place_vals_gather")
    cap32 = cap32_of(capacity_words)
    if B * nbe * 9 >= 2 ** 31 or B * cap32 >= 2 ** 31:
        raise ValueError("place_vals_gather: the batch is too large for the "
                         "kernel's 32-bit indices")
    words = gather_range_words(B, capacity_words, sm_count(vals32.device))
    out = torch.empty((B, cap32), dtype=torch.int32, device=vals32.device)
    LAUNCHES["place_vals_gather"] += 1
    _build.launch("psx_place_vals_gather", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, words, _build.ptr(out))
    return out


def place_vals_gather_ranges_plain(vals32, e0, *, capacity_words,
                                   range_words, base=0,
                                   threads=PLACE_THREADS, chunk=PLACE_CHUNK):
    """K8's decomposition (a plain model for the tests; nothing on the
    main path runs it): equal to :func:`place_vals_gather_plain` where
    each frame's ``e0`` row is non-decreasing.

    A frame's (cap32,) words are cut into ranges of ``range_words`` words
    (the last may be shorter), each computed alone. The range's blocks,
    start - 8 <= e0 < end, are found by :func:`cta_lower_bound_plain` and
    taken ``chunk`` at a time. A thread owns the four words [4t - shift,
    4t - shift + 4) of the range, shift being the range's offset in words
    from a 16-byte boundary of the output: (base + b cap32 + start) mod 4
    for frame b, where the output starts ``base`` words past one (0 for a
    fresh allocation). For each chunk, the thread's first block, the
    first with e0 >= its first word - 8, comes from a merge: staged block
    k (k >= 1) names the threads whose first word - 8 lies in (e0[k - 1],
    e0[k]], runs that no two blocks share (checked here); a thread below
    e0[0] + 8 starts at block 0, one past e0[-1] + 8 has none. The thread
    walks the blocks from there up to e0 = its last word, ORing the slot
    each puts on each of its words. The words in the range are kept;
    words at or past cap32 lie in no range."""
    B, nbe, _ = vals32.shape
    cap32 = cap32_of(capacity_words)
    dev = vals32.device
    v = vals32.to(torch.int64) & bitpack.U32_MASK
    e = e0.to(torch.int64)
    slot = torch.arange(4, device=dev)
    rows = []
    for b in range(B):
        images = []
        for start in range(0, cap32, range_words):
            n = min(range_words, cap32 - start)
            shift = (base + b * cap32 + start) % 4
            lo, _ = cta_lower_bound_plain(e[b], start - 8, threads)
            hi, _ = cta_lower_bound_plain(e[b], start + n, threads)
            nq = -(-(n + shift) // 4)          # threads with words
            w0 = start - shift + 4 * torch.arange(nq, device=dev)
            acc = torch.zeros((nq, 4), dtype=torch.int64, device=dev)
            for j0 in range(lo, hi, chunk):
                se = e[b, j0:min(j0 + chunk, hi)]
                sv = v[b, j0:j0 + se.numel()]
                # The merge: block k's run of threads (t0, t1].
                t0 = ((se[:-1] + 8 - w0[0]) >> 2) + 1
                t1 = (se[1:] + 8 - w0[0]) >> 2
                t0, t1 = t0.clamp(min=0), t1.clamp(max=nq - 1)
                runs = (t1 - t0 + 1).clamp(min=0)
                at = torch.repeat_interleave(t0, runs) + (
                    torch.arange(int(runs.sum()), device=dev)
                    - torch.repeat_interleave(torch.cumsum(runs, 0) - runs,
                                              runs))
                first = torch.full((nq,), -1, dtype=torch.int64, device=dev)
                first[at] = torch.repeat_interleave(
                    torch.arange(1, se.numel(), device=dev), runs)
                assert at.unique().numel() == at.numel()
                k = torch.where(w0 - 8 <= se[0], 0, first)
                k = torch.where(w0 - 8 > se[-1], se.numel(), k)
                assert (k >= 0).all()
                while True:
                    kk = k.clamp(max=se.numel() - 1)
                    live = (k < se.numel()) & (se[kk] <= w0 + 3)
                    if not live.any():
                        break
                    s = (w0 - se[kk])[:, None] + slot
                    ok = live[:, None] & (s >= 0) & (s <= 8)
                    acc |= torch.where(ok, sv[kk[:, None], s.clamp(0, 8)], 0)
                    k = k + live.to(k.dtype)
            images.append(acc.reshape(-1)[shift:shift + n])
        rows.append(torch.cat(images))
    return bitpack.u32_to_i32(torch.stack(rows))


# ------------------------------------------------------------------- K9

def place_streams_u32_plain(streams, goff, *, capacity_words):
    """(B, NBe, 16) u16 streams + (B, NBe) global bit offsets -> (B, cap32)
    int32 placed u32 words: ``bitpack._place_streams_u32`` (words at or
    past cap32 drop)."""
    return bitpack.u32_to_i32(bitpack._place_streams_u32(
        streams, goff, capacity_words=capacity_words))


def place_streams_plain(streams, goff, total_bits, *, capacity_words):
    """(B, NBe, 16) u16 streams + (B, NBe) global bit offsets -> (B,
    capacity_words) int32 u16 words: ``bitpack._place_streams`` (offsets
    past the capacity drop). ``total_bits`` is taken for the JAX
    signature; the offsets say everything."""
    return bitpack._place_streams(streams, goff,
                                  capacity_words=capacity_words).to(
        torch.int32)


def place_streams_grid(batch, capacity_words, sms=None):
    """K9's launch on the current CUDA device (or one of ``sms`` SMs):
    (CTAs, threads a CTA), a CTA per range of a frame's words (K4's
    ranges)."""
    return place_vals_grid(batch, capacity_words, sms)


def place_streams_u32(streams, goff, *, capacity_words):
    """K9 (``csrc/bitpack_streams.cu``): see
    :func:`place_streams_u32_plain`. Precondition: each frame's ``goff``
    row is non-decreasing (an exclusive cumsum of block bits is); the
    kernel searches it. Each output word is written once, so the output is
    not zero-filled first."""
    if not _on_cuda(streams, "place_streams"):
        return place_streams_u32_plain(streams, goff,
                                       capacity_words=capacity_words)
    _require(streams, torch.int32, 3, "place_streams streams")
    _require(goff, torch.int32, 2, "place_streams goff")
    B, nbe, w = streams.shape
    if w != BCAP or goff.shape != (B, nbe) or goff.device != streams.device \
            or streams.data_ptr() % 16:
        raise ValueError(f"place_streams: expected 16-byte aligned streams "
                         f"(B, NBe, {BCAP}) and goff (B, NBe) on one device")
    cap32 = cap32_of(capacity_words)
    if B * nbe * BCAP >= 2 ** 31 or B * cap32 >= 2 ** 31 \
            or 32 * (cap32 + 8) >= 2 ** 31:
        raise ValueError("place_streams: the batch is too large for the "
                         "kernel's 32-bit indices")
    words = place_range_words(B, capacity_words, sm_count(streams.device))
    out = torch.empty((B, cap32), dtype=torch.int32, device=streams.device)
    LAUNCHES["place_streams"] += 1
    _build.launch("psx_place_streams", streams, _build.ptr(streams),
                  _build.ptr(goff), B, nbe, cap32, words, _build.ptr(out))
    return out


def place_streams(streams, goff, total_bits, *, capacity_words):
    """K9 with the JAX signature: see :func:`place_streams_plain`; on the
    card :func:`place_streams_u32`'s words as u16 values. ``total_bits``
    is taken for the JAX signature."""
    if not _on_cuda(streams, "place_streams"):
        return place_streams_plain(streams, goff, total_bits,
                                   capacity_words=capacity_words)
    return bitpack.u16_values(
        place_streams_u32(streams, goff, capacity_words=capacity_words),
        capacity_words)


def place_streams_ranges_plain(streams, goff, *, capacity_words,
                               range_words, threads=PLACE_THREADS):
    """K9's decomposition (a plain model for the tests; nothing on the
    main path runs it): equal to :func:`place_streams_u32_plain` where
    each frame's ``goff`` row is non-decreasing.

    A frame's (cap32,) words are cut into ranges of ``range_words`` words
    (the last may be shorter), each computed alone: the blocks whose nine
    placed words start in [start - 8, end), so with 32 (start - 8) <= goff
    < 32 end, found by :func:`cta_lower_bound_plain` on the goff row, turn
    their streams into those words (``bitpack.streams_to_u32``) and OR the
    ones that land in the range into a zeroed image; the images are
    concatenated. Words at or past cap32 lie in no range."""
    B = streams.shape[0]
    cap32 = cap32_of(capacity_words)
    g = goff.to(torch.int64)
    slot = torch.arange(9, device=streams.device)
    rows = []
    for b in range(B):
        images = []
        for start in range(0, cap32, range_words):
            n = min(range_words, cap32 - start)
            lo, _ = cta_lower_bound_plain(g[b], 32 * (start - 8), threads)
            hi, _ = cta_lower_bound_plain(g[b], 32 * (start + n), threads)
            vals, e = bitpack.streams_to_u32(streams[b, lo:hi], g[b, lo:hi])
            w = (e[:, None] + slot - start).reshape(-1)
            x = vals.reshape(-1)
            keep = (w >= 0) & (w < n) & (x != 0)
            images.append(bitpack.or_scatter(n, w[keep], x[keep]))
        rows.append(torch.cat(images))
    return bitpack.u32_to_i32(torch.stack(rows))


# ------------------------------------------------------------------ K10

def pack_block_streams_plain(codes, bits):
    """(B, NBe, S) symbols (u32 codes, bit lengths 0-32) -> (streams (B,
    NBe, 16) int32 u16 values, block bits (B, NBe) int32):
    ``bitpack._pack_block_streams`` on every block. Blocks over 256 bits
    are cut; block bits count them whole."""
    B, nbe, S = codes.shape
    bits64 = bits.to(torch.int64)
    offs = torch.cumsum(bits64, dim=2) - bits64
    streams = bitpack._pack_block_streams(
        codes.reshape(-1, S), bits64.reshape(-1, S), offs.reshape(-1, S),
        bcap=BCAP).reshape(B, nbe, BCAP)
    return (streams.to(torch.int32),
            (offs[..., -1] + bits64[..., -1]).to(torch.int32))


def _lane_or(x):
    """The OR over the last axis (32 lanes) in five halving steps; every
    lane ends with the whole OR."""
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x | x[..., lane ^ off]
    return x


def pack_block_streams_lanes_plain(codes, bits):
    """K10's decomposition step for step (a plain model for the tests;
    nothing on the main path runs it): equal to
    :func:`pack_block_streams_plain`.

    A block is a warp's row: lane l takes symbols l, l + 32, ... in rounds
    of 32; a Hillis-Steele scan of the bit lengths in each round, plus the
    rounds before, gives each symbol's offset o. The symbol's code, masked
    to its b bits (0 bits: skipped), lies MSB-first at bits [o, o + b) of
    eight u32 windows, so in at most two: window o >> 5 and the next
    (bits past the 256th drop). The windows are the OR of every symbol's
    two (the kernel ORs them into shared memory), and word 2k of the
    stream is window k >> 16, word 2k + 1 window k & 0xFFFF."""
    B, nbe, S = codes.shape
    rounds = -(-S // 32)
    pad = (0, 32 * rounds - S)
    c = torch.nn.functional.pad(codes.reshape(-1, S).to(torch.int64)
                                & bitpack.U32_MASK, pad)
    b = torch.nn.functional.pad(bits.reshape(-1, S).to(torch.int64), pad)
    c, b = c.reshape(-1, rounds, 32), b.reshape(-1, rounds, 32)
    incl = b
    off = 1
    while off < 32:
        incl = incl + torch.nn.functional.pad(incl[..., :-off], (off, 0))
        off *= 2
    carry = torch.cumsum(incl[..., -1], dim=1) - incl[..., -1]
    o = carry[..., None] + incl - b
    code = c & torch.where(
        b >= 32, bitpack.U32_MASK,
        bitpack._shl(torch.ones_like(b), b.clamp(0, 31)) - 1)
    # The 64-bit field of windows q and q + 1 holds the code at bits
    # [64 - s - b, 64 - s), s = o & 31 (``place_shared`` in
    # csrc/bitpack_streams.cu).
    sbits = 64 - (o & 31) - b
    hi = torch.where(sbits >= 32,
                     bitpack._shl(code, (sbits - 32).clamp(0, 31)),
                     code >> (32 - sbits).clamp(0, 31)) & bitpack.U32_MASK
    lo = torch.where(sbits < 32, bitpack._shl(code, sbits.clamp(0, 31)),
                     0) & bitpack.U32_MASK
    q = o >> 5
    on = b > 0
    windows = []
    for k in range(8):
        part = (torch.where(on & (q == k), hi, 0)
                | torch.where(on & (q + 1 == k), lo, 0))
        lane_acc = part[:, 0]
        for r in range(1, rounds):
            lane_acc = lane_acc | part[:, r]
        windows.append(_lane_or(lane_acc)[:, 0])
    w = torch.stack(windows, dim=1)
    streams = torch.stack([w >> 16, w & 0xFFFF], dim=2).reshape(B, nbe, BCAP)
    total = (carry[:, -1] + incl[:, -1, -1]).reshape(B, nbe)
    return streams.to(torch.int32), total.to(torch.int32)


# K10's statistics, per CTA (``stats_out`` of :func:`pack_block_streams`):
# tiles packed; SM cycles waiting for them, packing (warp 0's rows), at each
# tile's closing barrier, and in all (thread 0's clock); the grid, CTAs an
# SM, the SM.
PACK_STAT_NAMES = ("tiles", "wait_cycles", "pack_cycles", "barrier_cycles",
                   "all_cycles", "grid", "per_sm", "sm")


def pack_block_streams(codes, bits, stats_out=None):
    """K10 (``csrc/bitpack_streams.cu``): see
    :func:`pack_block_streams_plain`. int64 codes go to the kernel as
    int32 bit patterns. ``stats_out``: optional (n, len(PACK_STAT_NAMES))
    int32 on the card, filled for the first n CTAs (rows past the grid are
    left as they are); measurement only."""
    if not _on_cuda(codes, "pack_block_streams"):
        return pack_block_streams_plain(codes, bits)
    if stats_out is not None:
        _require(stats_out, torch.int32, 2, "pack_block_streams stats_out")
        if stats_out.shape[1] != len(PACK_STAT_NAMES) \
                or stats_out.device != codes.device:
            raise ValueError("pack_block_streams: stats_out must be (n, "
                             f"{len(PACK_STAT_NAMES)}) on {codes.device}")
    codes32 = (bitpack.u32_to_i32(codes) if codes.dtype == torch.int64
               else codes.to(torch.int32).contiguous())
    bits32 = bits.to(device=codes.device, dtype=torch.int32).contiguous()
    if codes32.ndim != 3 or bits32.shape != codes32.shape:
        raise ValueError("pack_block_streams: expected codes and bits "
                         "(B, NBe, S)")
    B, nbe, S = codes32.shape
    streams = torch.empty((B, nbe, BCAP), dtype=torch.int32,
                          device=codes.device)
    block_bits = torch.empty((B, nbe), dtype=torch.int32, device=codes.device)
    LAUNCHES["pack_block_streams"] += 1
    _build.launch("psx_pack_block_streams", codes32, _build.ptr(codes32),
                  _build.ptr(bits32), B * nbe, S, _build.ptr(streams),
                  _build.ptr(block_bits), _opt_ptr(stats_out),
                  0 if stats_out is None else stats_out.shape[0])
    return streams, block_bits
