"""Plain reference of psxavenc's BS v3 frame encoder (``-v v3``, mdec.c),
in plain PyTorch on any device.

From NV21 frames and per-frame byte budgets it gives each frame's buffer
as psxavenc writes it under ``-v v3``. All but the DCs and the end of
frame is ``benchref/bs.py``'s v2 reference (the blocks in encode order,
the islow FDCT, the quantisation, the AC codes, the packing); here:

- each block's DC level (DC / 16 rounded and clamped, as in v2) is coded
  as a difference from the last DC of its type, with a predictor each for
  Cr, Cb and Y, all 0 at the frame's start: ``delta = round((dc - last) /
  4)``, half away from zero, then ``last += 4 * delta`` (mdec.c:455-480).
  The loop runs block after block in encode order (macroblocks
  column-major; Cr, Cb, Y1-Y4), as mdec.c's does;
- a difference of size s (``|delta|`` in [2**(s-1), 2**s - 1]) is the
  size's prefix from the chroma or the luma tree (mdec.c:159-187), then s
  bits: ``delta`` where it is positive, ``delta + 2**s - 1`` where it is
  negative; a difference of 0 is ``00`` for chroma and ``100`` for luma;
- the quant scale is the first of 1..63 at which the frame fits, counted
  with the frame's own DC bits where v2 counts 10 a block;
- the end of frame is the 10-bit 0x3FF, and the header's version is 3.

Departures from mdec.c:

- mdec.c reads each code from ``dc_huffman_map[type][delta & 0x1FF]``,
  which it fills from the trees for the differences -255..255 only. The
  key 0x100 (delta -256, and delta +256, which wraps to the same key) is
  never filled: mdec.c writes whatever that entry holds. Here both take
  delta -255's code. Only a DC level's swing between +510 and -512 across
  two blocks of one type reaches them.
- mdec.c encodes the whole frame again at each scale until it fits; here
  each scale's bits are summed for every frame at once and a frame's
  buffer is written once, at its scale. The DC codes do not depend on the
  scale.

``shared=True`` runs the chain with one predictor for all three block
types: the control, which breaks v3's per-type prediction.

This file imports nothing of the program under test.
"""

import torch

from . import bs

BS_VERSION_V3 = 3
EOF_CODE_V3 = 0x3FF
CR, CB, Y = 0, 1, 2

# mdec.c:159-187, {c_bits, c_value, dc_bits} by size category s = dc_bits
# + 1 of a nonzero difference: the prefix's bits and value.
DC_CHROMA_TREE = [(2, 0x1, 0), (2, 0x2, 1), (3, 0x6, 2), (4, 0xE, 3),
                  (5, 0x1E, 4), (6, 0x3E, 5), (7, 0x7E, 6), (8, 0xFE, 7)]
DC_LUMA_TREE = [(2, 0x0, 0), (2, 0x1, 1), (3, 0x5, 2), (3, 0x6, 3),
                (4, 0xE, 4), (5, 0x1E, 5), (6, 0x3E, 6), (7, 0x7E, 7)]
# A difference of 0: (bits, code) by block type.
DC_ZERO = {CR: (2, 0x0), CB: (2, 0x0), Y: (3, 0x4)}


def block_type(n):
    """Cr, Cb or Y: the type of block ``n`` of a frame in encode order."""
    return min(n % 6, Y)


def dc_code(kind, delta):
    """(bits, code) of the DC difference ``delta`` (-256..256) of a block
    of type ``kind``."""
    if delta in (-256, 256):
        delta = -255
    if delta == 0:
        return DC_ZERO[kind]
    size = abs(delta).bit_length()
    tree = DC_LUMA_TREE if kind == Y else DC_CHROMA_TREE
    c_bits, c_value, dc_bits = tree[size - 1]
    assert dc_bits == size - 1
    suffix = delta if delta > 0 else delta + (1 << size) - 1
    return c_bits + size, (c_value << size) | suffix


def _code_tables(device):
    """(3, 513) code lengths and codes of the differences -256..256 by
    block type, indexed by delta + 256."""
    rows = [[dc_code(kind, d) for d in range(-256, 257)]
            for kind in (CR, CB, Y)]
    t = torch.tensor(rows, dtype=torch.int64, device=device)
    return t[..., 0], t[..., 1]


def dc_differences(dc, shared=False):
    """(F, NB) DC levels in encode order -> (F, NB) differences, mdec.c's
    loop over the blocks with a predictor a block type (one for all with
    ``shared``), each frame's predictors starting at 0."""
    f, nb = dc.shape
    dc = dc.to(torch.int64)
    last = torch.zeros((f, 3), dtype=torch.int64, device=dc.device)
    out = torch.empty_like(dc)
    for n in range(nb):
        kind = CR if shared else block_type(n)
        delta = bs._div_round(dc[:, n] - last[:, kind], 4)
        last[:, kind] += 4 * delta
        out[:, n] = delta
    return out


def dc_codes(dc, shared=False):
    """(F, NB) DC levels -> their (F, NB) code lengths and codes."""
    delta = dc_differences(dc, shared)
    nb = dc.shape[1]
    kinds = torch.tensor([block_type(n) for n in range(nb)],
                         device=dc.device)
    bits, code = _code_tables(dc.device)
    return bits[kinds, delta + 256], code[kinds, delta + 256]


def choose_scales(ac, dc_total, budgets):
    """First quant scale in 1..63 at which each frame fits with its own
    DC bits ``dc_total`` (F,) (64 where none does)."""
    f, nb, _ = ac.shape
    table_bits, _ = bs._tables(ac.device)
    fixed = dc_total + nb * bs.EOB_BITS + bs.EOF_BITS
    scale = torch.full((f,), 64, dtype=torch.int64, device=ac.device)
    for s in range(1, 64):
        todo = scale == 64
        if not bool(todo.any()):
            break
        idx = todo.nonzero()[:, 0]
        bits, _ = bs._ac_bits(bs._ac_levels(ac[idx], torch.full(
            (len(idx),), s, device=ac.device)), table_bits)
        total = bits.sum(dim=(1, 2)) + fixed[idx]
        fits = 8 + 2 * ((total + 15) // 16) <= budgets[idx]
        scale[idx[fits]] = s
    return scale


def frame_buffer(dc_bits, dc_code_, ac, scale, budget):
    """One frame's buffer (budget bytes, uint8 tensor) at ``scale`` from
    its (NB,) DC code lengths and codes, and the bytes it uses rounded up
    to 4."""
    nb = dc_bits.shape[0]
    table_bits, table_value = bs._tables(ac.device)
    levels = bs._ac_levels(ac[None], scale.reshape(1))[0]       # (NB, 63)
    bits, nz = bs._ac_bits(levels, table_bits)
    run = bs._runs(nz)
    esc = bits == bs.ESCAPE_BITS
    vlc = (table_value[run.clamp(max=63), levels.abs()] << 1) | \
        (levels < 0).long()
    escape = (1 << 16) | (run << 10) | (levels & 0x3FF)
    code = torch.where(esc, escape, vlc)
    eob = torch.full((nb, 1), bs.EOB_CODE, device=ac.device)
    sym_codes = torch.cat([dc_code_[:, None], code, eob], 1).reshape(-1)
    sym_bits = torch.cat([dc_bits[:, None], bits,
                          torch.full((nb, 1), bs.EOB_BITS,
                                     device=ac.device)], 1).reshape(-1)
    keep = sym_bits > 0
    sym_codes = torch.cat([sym_codes[keep],
                           torch.tensor([EOF_CODE_V3], device=ac.device)])
    sym_bits = torch.cat([sym_bits[keep],
                          torch.tensor([bs.EOF_BITS], device=ac.device)])
    payload, total = bs._pack(sym_codes, sym_bits)
    half_words = (int(nz.sum()) + 2 * nb + 2 + 0x3F) & ~0x3F
    blocks_used = (half_words + 1) >> 1
    s = int(scale)
    header = torch.tensor([blocks_used & 0xFF, blocks_used >> 8, 0x00, 0x38,
                           s & 0xFF, s >> 8, BS_VERSION_V3, 0x00],
                          device=ac.device)
    out = torch.zeros(int(budget), dtype=torch.uint8, device=ac.device)
    body = torch.cat([header, payload]).to(torch.uint8)
    if len(body) > len(out):
        raise ValueError("the frame's bitstream overruns its budget")
    out[:len(body)] = body
    return out, (8 + 2 * ((total + 15) // 16) + 3) & ~3


def encode_frames(frames, budgets, width, height, dct=bs.fdct_islow,
                  shared=False):
    """(F, w*h*3/2) uint8 NV21 frames and (F,) budgets -> (list of F
    uint8 buffers, (F,) quant scales, list of F bytes used, (F,) DC
    bits). A frame that fits no scale gets scale 64 and an empty buffer
    (mdec.c refuses it)."""
    budgets = budgets.to(torch.int64)
    dc, ac = bs.coefficients(frames, width, height, dct)
    dc_bits, dc_code_ = dc_codes(dc, shared)
    dc_total = dc_bits.sum(1)
    scale = choose_scales(ac, dc_total, budgets)
    out, used = [], []
    for j in range(frames.shape[0]):
        if int(scale[j]) == 64:
            out.append(torch.zeros(0, dtype=torch.uint8, device=ac.device))
            used.append(0)
        else:
            buf, n = frame_buffer(dc_bits[j], dc_code_[j], ac[j], scale[j],
                                  budgets[j])
            out.append(buf)
            used.append(n)
    return out, scale, used, dc_total


def frame_work(frames, width, height, scales):
    """Per-frame census at the given scales, as ``bs.frame_work`` with v3's
    DC codes: (nonzero AC levels, blocks over 256 bits, nonzero levels in
    those blocks), each (F,)."""
    table_bits, _ = bs._tables(frames.device)
    dc, ac = bs.coefficients(frames, width, height)
    dc_bits, _ = dc_codes(dc)
    bits, nz = bs._ac_bits(bs._ac_levels(ac, scales.to(torch.int64)),
                           table_bits)
    long = bits.sum(-1) + dc_bits + bs.EOB_BITS > 256
    return nz.sum(dim=(1, 2)), long.sum(1), (nz.sum(-1) * long).sum(1)
