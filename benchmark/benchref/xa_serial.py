"""Plain reference of psxavenc -t xa at its defaults for tracks on which
``adpcm.encode_streams``' passes do not settle: the program's .xa file is
held unit for unit to the serial ADPCM encoder without running the serial
walk, in plain PyTorch.

``encode_streams`` reaches the serial answer by passes that start every
segment again from its predecessor's end. On a loud steady tone two
encodes started from different states stay apart for good, so each pass
settles one more segment: a 180 s track's 3,797 segments a channel would
take as many passes of 64 unit steps, far more than a run's check can
spend. Decoding forgets its start state within a few units where
encoding does not, so the serial answer is checked instead:

1. the file's sectors are read back into each unit's header (filter and
   shift) and 28 nibbles, a channel at a time (``read_units``);
2. the units are decoded (libpsxav's decoder recurrence, adpcm.c's
   ``decode``) by segments in passes from guessed states, each pass
   starting a segment from its predecessor's end, until no start changes:
   a fixed point is the serial decode, which gives every unit's start
   state (``decode_states``);
3. every unit is encoded at once from its decoded start state by
   ``adpcm.encode_units`` and must give the file's header and nibbles.

A stream's first unit starts from the zero state, as the serial encoder's
does. If every unit encoded from the state decoded before it gives the
file's unit, each decoded state is, by induction from the first unit, the
serial encoder's, and the file's units are its units. The reference then
writes the .xa file from those units itself (``xa.py``'s subheaders, EDC
and EOF flag) for the caller to compare byte for byte; where a unit
differs there is no such file (``xa_file_checked`` returns None).

This file imports nothing of the program under test.
"""

import numpy as np
import torch

from . import adpcm, strmux
from . import xa as ref_xa

UNITS_A_GROUP = 4           # units of each channel in a sound group
CHUNK = 1 << 16             # units encoded a step in the check


def unit_layout(lengths):
    """Each sector's per-channel samples -> (offsets, limits) of a
    channel's units, as ``strmux.xa_payloads`` lays them out."""
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    k = 28 * np.arange(ref_xa.UNITS_A_SECTOR, dtype=np.int64)
    offsets = (start[:, None] + k[None, :]).reshape(-1)
    limits = (np.asarray(lengths)[:, None] - k[None, :]).reshape(-1)
    return offsets, limits


def read_units(data, n_sectors):
    """The bytes of an .xa file of ``n_sectors`` stereo 4-bit sectors ->
    headers (2, N) and nibbles (2, N, 28) int64 arrays, N units a channel
    in stream order, or None when the file has another length."""
    if len(data) != n_sectors * ref_xa.SECTOR:
        return None
    sec = np.frombuffer(data, np.uint8).reshape(n_sectors, ref_xa.SECTOR)
    blk = sec[:, 8:8 + strmux.XA_GROUPS * 128].reshape(
        n_sectors, strmux.XA_GROUPS, 128).astype(np.int64)
    heads, nibs = [], []
    for c in range(2):
        h = np.stack([blk[:, :, strmux.HEADER_POS[2 * j + c]]
                      for j in range(UNITS_A_GROUP)], -1)
        b = np.stack([blk[:, :, 0x10 + j + 4 * np.arange(28)]
                      for j in range(UNITS_A_GROUP)], 2)
        heads.append(h.reshape(-1))
        nibs.append(((b >> 4) if c else (b & 0xF)).reshape(-1, 28))
    return np.stack(heads), np.stack(nibs)


def decode_units(headers, nibbles, p1, p2):
    """Decode (N,) units from their start states -> the (N,) states after
    them: each sample the nibble sign-extended from bit 15 and shifted
    right by the header's shift, plus the filter's prediction from the
    last two samples, clipped to s16."""
    dev = headers.device
    k1 = torch.tensor(adpcm.FILTER_K1, device=dev)[headers >> 4]
    k2 = torch.tensor(adpcm.FILTER_K2, device=dev)[headers >> 4]
    shift = headers & 0xF
    a1, a2 = p1, p2
    for i in range(adpcm.UNIT):
        pred = (k1 * a1 + k2 * a2 + 32) >> 6
        dec = adpcm._to_int16(nibbles[:, i] << adpcm.SHIFT_RANGE_4BIT) \
            >> shift
        a2, a1 = a1, (dec + pred).clamp(-0x8000, 0x7FFF)
    return a1, a2


def decode_states(headers, nibbles, first, guess1, guess2,
                  segment=adpcm.SEGMENT):
    """Units of several streams laid end to end: (N,) headers, (N, 28)
    nibbles, (N,) bool marking each stream's first unit, and (N,) guessed
    start states -> (N,) start states p1, p2 of the serial decode, and the
    passes it took.

    As ``adpcm.encode_streams``' passes, with the decoder: the first pass
    decodes every segment from its first unit's guess, every later pass
    starts a segment from its predecessor's end and decodes again only the
    segments whose start changed, until none changed."""
    dev = headers.device
    n = headers.shape[0]
    idx = torch.arange(n, device=dev)
    stream_start = torch.where(first, idx, 0).cummax(0).values
    seg_first = first | ((idx - stream_start) % segment == 0)
    seg_of = torch.cumsum(seg_first.long(), 0) - 1
    seg_start = seg_first.nonzero()[:, 0]
    n_seg = len(seg_start)
    pos = idx - seg_start[seg_of]
    grid = torch.full((n_seg, segment), -1, dtype=torch.int64, device=dev)
    grid[seg_of, pos] = idx
    opens_stream = first[seg_start]
    p1 = torch.where(opens_stream, 0, guess1[seg_start])
    p2 = torch.where(opens_stream, 0, guess2[seg_start])
    s1 = torch.zeros(n, dtype=torch.int64, device=dev)
    s2 = torch.zeros_like(s1)
    e1, e2 = torch.zeros_like(p1), torch.zeros_like(p2)
    todo = torch.arange(n_seg, device=dev)
    passes = 0
    while len(todo):
        a1, a2 = p1[todo], p2[todo]
        for k in range(segment):
            u = grid[todo, k]
            live = u >= 0
            if not bool(live.any()):
                break
            uu = u[live]
            s1[uu], s2[uu] = a1[live], a2[live]
            b1, b2 = decode_units(headers[uu], nibbles[uu], a1[live],
                                  a2[live])
            a1, a2 = a1.clone(), a2.clone()
            a1[live], a2[live] = b1, b2
        e1[todo], e2[todo] = a1, a2
        passes += 1
        n1 = torch.where(opens_stream, 0, torch.cat([e1.new_zeros(1),
                                                     e1[:-1]]))
        n2 = torch.where(opens_stream, 0, torch.cat([e2.new_zeros(1),
                                                     e2[:-1]]))
        todo = ((n1 != p1) | (n2 != p2)).nonzero()[:, 0]
        p1, p2 = n1, n2
    return s1, s2, passes


def check_units(cfg, master, data, device):
    """The program's .xa file ``data`` of an (n, 2) int16 master at
    44,100 Hz under ``cfg`` against the serial encoder -> (headers (2, N),
    nibbles (2, N, 28), the decode's passes), the file's units, where each
    unit encoded from the state decoded before it gives the file's unit;
    else None."""
    ref_xa.check_config(cfg)
    pcm = ref_xa.resample(master, device)
    lengths = ref_xa.sector_lengths(len(pcm))
    got = read_units(data, len(lengths))
    if got is None:
        return None
    offsets, limits = unit_layout(lengths)
    per = ref_xa.UNITS_A_SECTOR
    idx = torch.as_tensor(offsets, device=device)[:, None] + \
        torch.arange(adpcm.UNIT, device=device)
    units = []
    for c in range(2):
        col = torch.cat([pcm[:, c].to(torch.int64),
                         pcm.new_zeros(adpcm.UNIT * per, dtype=torch.int64)])
        units.append(col[idx.clamp(max=len(col) - 1)])
    units = torch.cat(units)
    lim = torch.as_tensor(np.concatenate([limits, limits]), device=device)
    headers = torch.as_tensor(got[0].reshape(-1), device=device)
    nibbles = torch.as_tensor(got[1].reshape(-1, adpcm.UNIT), device=device)
    n = len(offsets)
    first = torch.zeros(2 * n, dtype=torch.bool, device=device)
    first[0] = first[n] = True
    # The guesses of encode_streams: the last two samples before a unit.
    before = torch.cat([units.new_zeros((1, adpcm.UNIT)), units[:-1]])
    s1, s2, passes = decode_states(headers, nibbles, first,
                                   before[:, -1], before[:, -2])
    for lo in range(0, 2 * n, CHUNK):
        hi = min(lo + CHUNK, 2 * n)
        h, nib, _, _ = adpcm.encode_units(units[lo:hi], lim[lo:hi],
                                          s1[lo:hi], s2[lo:hi],
                                          filters=strmux.XA_FILTERS)
        if not (torch.equal(h, headers[lo:hi])
                and torch.equal(nib, nibbles[lo:hi])):
            return None
    return got[0], got[1], passes


def xa_file(headers, nibbles, device):
    """The bytes of the .xa file of stereo units, headers (2, N) and
    nibbles (2, N, 28) with N a whole number of sectors' units: the
    payloads as ``strmux.xa_payloads`` lays them out, the sectors as
    ``xa.xa_file`` writes them."""
    s = headers.shape[1] // ref_xa.UNITS_A_SECTOR
    h = headers.reshape(2, s, strmux.XA_GROUPS, UNITS_A_GROUP)
    nib = nibbles.reshape(2, s, strmux.XA_GROUPS, UNITS_A_GROUP, 28)
    blk = np.zeros((s, strmux.XA_GROUPS, 128), np.int64)
    for j in range(UNITS_A_GROUP):
        for c in range(2):
            blk[:, :, strmux.HEADER_POS[2 * j + c]] = h[c, :, :, j]
        pos = 0x10 + j + 4 * np.arange(28)
        blk[:, :, pos] = (nib[0, :, :, j] & 0xF) | (nib[1, :, :, j] << 4)
    blk[:, :, 4:8] = blk[:, :, 0:4]
    blk[:, :, 12:16] = blk[:, :, 8:12]
    payloads = torch.as_tensor(blk.reshape(s, -1).astype(np.uint8),
                               device=device)
    sectors = torch.zeros((s, ref_xa.SECTOR), dtype=torch.uint8,
                          device=device)
    head = torch.tensor(ref_xa.SUBHEADER, dtype=torch.uint8, device=device)
    sectors[:, 0:4] = head
    sectors[:, 4:8] = head
    sectors[:, 8:8 + payloads.shape[1]] = payloads
    crc = ref_xa.edc(sectors[:, :ref_xa.EDC_AT])
    for k in range(4):
        sectors[:, ref_xa.EDC_AT + k] = ((crc >> (8 * k)) & 0xFF).to(
            torch.uint8)
    sectors[-1, 2] |= strmux.SUBMODE_EOF
    sectors[-1, 6] |= strmux.SUBMODE_EOF
    return sectors.cpu().numpy().tobytes()


def xa_file_checked(cfg, master, data, device):
    """The reference's .xa file for the program's file ``data`` of
    ``master`` (see ``check_units``), or None where a unit of ``data`` is
    not the serial encoder's."""
    got = check_units(cfg, master, data, device)
    if got is None:
        return None
    return xa_file(got[0], got[1], device)
