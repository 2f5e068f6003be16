"""Plain reference of psxavenc's ADPCM unit encoder (libpsxav adpcm.c) and
of the .vag file (psxavenc filefmt.c), in plain PyTorch on any device.

A unit is 28 samples. For each filter the encoder finds the least shift
that keeps the residuals of the raw samples in range, tries that shift and
its two neighbours through the decoder's recurrence, and keeps the
(filter, shift) of least squared error, the first in (filter, shift) order
on a tie. The decoder's last two samples carry into the next unit.

That carry makes a stream serial. The reference cuts the streams into
segments, encodes all segments at once from guessed start states, then
starts each segment again from its predecessor's end until no start
changes (``encode_streams``). A fixed point of that iteration is the
serial answer, unit for unit. ``rounds=1`` stops after the first pass,
from the guesses: the control, which breaks the guarantee that a file's
bytes are psxavenc's.

This file imports nothing of the program under test.
"""

import os

import torch

FILTER_K1 = (0, 60, 115, 98, 122)
FILTER_K2 = (0, 0, -52, -55, -60)
SPU_FILTERS, SHIFT_RANGE_4BIT = 5, 12
UNIT = 28
SEGMENT = 64

VAG_HEADER = 0x30
BLOCK = 16
FLAG_LOOP_TRAP = 5


def encode_units(units, limits, p1, p2, filters=SPU_FILTERS,
                 shift_range=SHIFT_RANGE_4BIT):
    """(N, 28) samples, (N,) valid counts and (N,) start states -> (N,)
    headers, (N, 28) nibbles and the (N,) end states."""
    dev = units.device
    n = units.shape[0]
    pos = torch.arange(UNIT, device=dev)
    x = torch.where(pos < limits[:, None], units.to(torch.int64), 0)
    k1 = torch.tensor(FILTER_K1[:filters], device=dev)
    k2 = torch.tensor(FILTER_K2[:filters], device=dev)
    lo_lim, hi_lim = -0x8000 >> shift_range, 0x7FFF >> shift_range

    # The least shift per filter, from the raw samples' residuals.
    prev1 = torch.cat([p1.to(torch.int64)[:, None], x[:, :-1]], 1)
    prev2 = torch.cat([p2.to(torch.int64)[:, None], prev1[:, :-1]], 1)
    r = x[..., None] - ((k1 * prev1[..., None] + k2 * prev2[..., None]
                         + 32) >> 6)                           # (N, 28, F)
    s_min = r.amin(1).clamp(max=0)
    s_max = r.amax(1).clamp(min=0)
    rs = torch.arange(shift_range + 1, device=dev)
    first_max = ((s_max[..., None] >> rs) <= hi_lim).to(torch.int64) \
        .argmax(-1)
    first_min = ((s_min[..., None] >> rs) >= lo_lim).to(torch.int64) \
        .argmax(-1)
    true_shift = shift_range - torch.maximum(first_max, first_min)
    # argmax of an all-false row is 0: a residual out of range at every
    # shift takes the whole range, as the encoder's loops do.
    none_max = ((s_max[..., None] >> rs) > hi_lim).all(-1)
    none_min = ((s_min[..., None] >> rs) < lo_lim).all(-1)
    true_shift = torch.where(none_max | none_min, 0, true_shift)

    # Candidates: (filter, shift) for shift in true-1..true+1, in range.
    lo = (true_shift - 1).clamp(min=0)
    hi = (true_shift + 1).clamp(max=shift_range)
    shift = lo[..., None] + torch.arange(3, device=dev)        # (N, F, 3)
    valid = shift <= hi[..., None]
    shift = shift.clamp(max=shift_range)
    kk1, kk2 = k1[:, None], k2[:, None]
    a1 = p1.to(torch.int64)[:, None, None].expand(n, filters, 3)
    a2 = p2.to(torch.int64)[:, None, None].expand(n, filters, 3)
    mse = torch.zeros((n, filters, 3), dtype=torch.int64, device=dev)
    mask = 0xFFFF >> shift_range
    nib = []
    for i in range(UNIT):
        xi = x[:, i, None, None]
        pred = (kk1 * a1 + kk2 * a2 + 32) >> 6
        enc = (((xi - pred) << shift) + (1 << (shift_range - 1))) \
            >> shift_range
        enc = enc.clamp(lo_lim, hi_lim) & mask
        dec = _to_int16(enc << shift_range) >> shift
        dec = (dec + pred).clamp(-0x8000, 0x7FFF)
        mse = mse + (dec - xi) ** 2
        a2, a1 = a1, dec
        nib.append(enc)
    mse = torch.where(valid, mse, torch.iinfo(torch.int64).max)
    best = mse.reshape(n, -1).argmin(-1)                       # first min
    rows = torch.arange(n, device=dev)
    flt, cand = best // 3, best % 3
    nibbles = torch.stack(nib, -1)[rows, flt, cand]            # (N, 28)
    headers = shift[rows, flt, cand] | (flt << 4)
    return headers, nibbles, a1[rows, flt, cand], a2[rows, flt, cand]


def _to_int16(x):
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def encode_streams(units, limits, first, rounds=None, segment=None, **kw):
    """Units of several streams laid end to end: (N, 28) samples, (N,)
    valid counts, (N,) bool marking each stream's first unit (its start
    state is zero). -> (N,) headers, (N, 28) nibbles.

    The units are cut into segments of ``segment`` units that never cross
    a stream's start. A pass encodes every segment at once, unit after
    unit, each from its start state; the first pass guesses a segment's
    start from the last two samples before it, and every later pass
    starts a segment from its predecessor's end and encodes again only the
    segments whose start changed. It stops when none changed, where every
    unit starts from its predecessor's end: the serial answer. ``rounds``
    caps the passes (None: to that fixed point)."""
    segment = segment or SEGMENT
    dev = units.device
    n = units.shape[0]
    units = units.to(torch.int64)
    idx = torch.arange(n, device=dev)
    stream_start = torch.where(first, idx, 0).cummax(0).values
    seg_first = first | ((idx - stream_start) % segment == 0)
    seg_of = torch.cumsum(seg_first.long(), 0) - 1           # (N,)
    n_seg = int(seg_of[-1]) + 1 if n else 0
    seg_start = seg_first.nonzero()[:, 0]                     # (S,)
    pos = idx - seg_start[seg_of]
    grid = torch.full((n_seg, segment), -1, dtype=torch.int64, device=dev)
    grid[seg_of, pos] = idx                   # unit index, -1 = no unit
    opens_stream = first[seg_start]
    before = (seg_start - 1).clamp(min=0)
    p1 = torch.where(opens_stream, 0, units[before, UNIT - 1])
    p2 = torch.where(opens_stream, 0, units[before, UNIT - 2])
    headers = torch.zeros(n, dtype=torch.int64, device=dev)
    nibbles = torch.zeros((n, UNIT), dtype=torch.int64, device=dev)
    e1, e2 = torch.zeros_like(p1), torch.zeros_like(p2)
    todo = torch.arange(n_seg, device=dev)
    done = 0
    while len(todo):
        a1, a2 = p1[todo], p2[todo]
        for k in range(segment):
            u = grid[todo, k]
            live = u >= 0
            if not bool(live.any()):
                break
            uu = u[live]
            h, nb, b1, b2 = encode_units(units[uu], limits[uu], a1[live],
                                         a2[live], **kw)
            headers[uu], nibbles[uu] = h, nb
            a1, a2 = a1.clone(), a2.clone()
            a1[live], a2[live] = b1, b2
        e1[todo], e2[todo] = a1, a2
        done += 1
        if rounds is not None and done >= rounds:
            break
        n1 = torch.where(opens_stream, 0, torch.cat([e1.new_zeros(1),
                                                     e1[:-1]]))
        n2 = torch.where(opens_stream, 0, torch.cat([e2.new_zeros(1),
                                                     e2[:-1]]))
        todo = ((n1 != p1) | (n2 != p2)).nonzero()[:, 0]
        p1, p2 = n1, n2
    return headers, nibbles


def spu_layout(n_samples):
    """(units, valid counts) of a mono stream of ``n_samples``."""
    n_units = -(-n_samples // UNIT)
    limits = [min(UNIT, n_samples - UNIT * t) for t in range(n_units)]
    return n_units, limits


def vag_files(clips, names, rate, rounds=None, device="cpu"):
    """Mono int16 clips (1-D tensors) -> the bytes of each one's .vag file
    as psxavenc -t vag writes it (filefmt.c: a zero block before the data,
    a loop-trap block after it, zero padding to 64 bytes, the 48-byte
    VAGp header with the output file's base name)."""
    unit_rows, limit_rows, first_rows, counts = [], [], [], []
    for pcm in clips:
        n_units, limits = spu_layout(len(pcm))
        padded = torch.zeros(n_units * UNIT, dtype=torch.int64,
                             device=device)
        padded[:len(pcm)] = pcm.to(device=device, dtype=torch.int64)
        unit_rows.append(padded.reshape(n_units, UNIT))
        limit_rows.append(torch.tensor(limits, device=device))
        first = torch.zeros(n_units, dtype=torch.bool, device=device)
        first[0] = True
        first_rows.append(first)
        counts.append(n_units)
    headers, nibbles = encode_streams(torch.cat(unit_rows),
                                      torch.cat(limit_rows),
                                      torch.cat(first_rows), rounds=rounds)
    blocks = torch.zeros((len(headers), BLOCK), dtype=torch.int64,
                         device=device)
    blocks[:, 0] = headers
    blocks[:, 2:] = (nibbles[:, 0::2] & 0xF) | (nibbles[:, 1::2] << 4)
    blocks = blocks.to(torch.uint8).cpu().numpy()
    out, at = [], 0
    for name, n_units in zip(names, counts):
        data = bytearray(BLOCK)                     # the leading zero block
        data += blocks[at:at + n_units].tobytes()
        at += n_units
        trap = bytearray(BLOCK)
        trap[1] = FLAG_LOOP_TRAP
        data += trap
        size = len(data)
        data += bytes((-size) % 64)
        header = bytearray(VAG_HEADER)
        header[0:4] = b"VAGp"
        header[4:8] = (0x20).to_bytes(4, "big")
        header[0x0C:0x10] = size.to_bytes(4, "big")
        header[0x10:0x14] = rate.to_bytes(4, "big")
        header[0x1E] = 1
        base = os.path.basename(name).encode()[:16]
        header[0x20:0x20 + len(base)] = base
        out.append(bytes(header) + bytes(data))
    return out
