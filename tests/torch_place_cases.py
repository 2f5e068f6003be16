"""Hand-made inputs of the placement K4, shared by the CPU tests, the card
tests and chip_smoke.py. Imports no JAX."""

import numpy as np


def tied_frames(frames, nbe, seed=44):
    """(vals32 (frames, nbe, 9) int32, e0 (frames, nbe) int32): frames of
    placed contributions whose u32 offsets tie: runs of blocks at one
    offset (steps of 0, 1, 2, 8, 12 and 16 words; every 16th step 9, so
    that blocks 32 apart never share a word), and block j owns bit j % 32
    of each of its slots, so the words are bit-disjoint and one output word
    gathers slot 8 of one block and slot 0 of several others."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0, 0, 0, 1, 2, 8, 12, 16], (frames, nbe - 1))
    steps[:, 15::16] = 9
    e0 = np.concatenate([np.zeros((frames, 1), np.int64),
                         np.cumsum(steps, axis=1)], axis=1)
    assert (e0[:, 32:] - e0[:, :-32] > 8).all()
    owner = (np.arange(nbe) % 32)[None, :, None]
    vals = rng.integers(0, 2, (frames, nbe, 9)).astype(np.int64) << owner
    vals = ((vals ^ 0x80000000) - 0x80000000).astype(np.int32)
    return vals, e0.astype(np.int32)


def boundaries_inside(e0, cap32, range_words):
    """The number of range starts (every ``range_words`` words of each
    frame, after the first) that fall inside some block's nine words: a
    block with e0 < start <= e0 + 8."""
    starts = np.arange(range_words, cap32, range_words)
    count = 0
    for row in np.asarray(e0):
        lo = np.searchsorted(row, starts - 8, side="left")
        hi = np.searchsorted(row, starts, side="left")
        count += int((hi > lo).sum())
    return count


def tied_streams(frames, nbe, seed=45):
    """(streams (frames, nbe, 16) int32 u16 values, goff (frames, nbe)
    int32): per-block streams whose global bit offsets tie. Block bits
    are drawn from 0 (a third of the blocks: their offsets tie with the
    next block's), 1-31 and 200-256; each stream holds random bits in its
    first ``bits`` bits only (MSB-first), so the placed blocks are
    bit-disjoint; goff is the exclusive sum of the bits."""
    rng = np.random.default_rng(seed)
    bits = np.where(rng.random((frames, nbe)) < 1 / 3, 0,
                    np.where(rng.random((frames, nbe)) < 0.7,
                             rng.integers(1, 32, (frames, nbe)),
                             rng.integers(200, 257, (frames, nbe))))
    pos = np.arange(256)[None, None, :]
    on = rng.integers(0, 2, (frames, nbe, 256)) * (pos < bits[..., None])
    weights = 1 << (15 - np.arange(16))
    streams = (on.reshape(frames, nbe, 16, 16) * weights).sum(axis=3)
    goff = np.cumsum(bits, axis=1) - bits
    assert (np.diff(goff, axis=1) == 0).any(axis=1).all()
    return streams.astype(np.int32), goff.astype(np.int32)
