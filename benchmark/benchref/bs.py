"""Plain reference of the MDEC BS v2 frame encoder (psxavenc mdec.c), in
plain PyTorch on any device.

From NV21 frames and per-frame byte budgets it works out each frame's
buffer as psxavenc writes it: the 8-byte BS header, then the bitstream of
16-bit words filled MSB-first and stored little-endian, zero up to the
budget. The steps follow mdec.c:

- macroblocks in column-major order, each as Cr, Cb, Y1..Y4 8x8 blocks of
  samples centred on 128;
- FFmpeg's integer "islow" forward DCT (jfdctint, CONST_BITS 13,
  PASS1_BITS 4) with its int16 store after the first pass;
- DC quantised by 16, each AC level by the PSX quantisation matrix times
  the frame's quant scale, both rounded half away from zero, wrapped to
  int16 and clamped to [-0x200, 0x1fe];
- the quant scale is the first of 1..63 at which the frame fits its budget
  (8 + 2 * ceil(bits / 16) bytes);
- a 10-bit DC, the AC levels as (run, level) Huffman codes or the 22-bit
  escape, a 2-bit end of block, and a 10-bit end of frame.

This file imports nothing of the program under test: its tables are its
own copies of mdec.c's.
"""

import torch

QUANT_PSX = [
    2, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
]

# Scan position -> row-major coefficient index.
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
]

# (run, |level|) -> (prefix bits, prefix value); a sign bit follows.
AC_CODES = {
    (0, 1): (2, 0x3), (1, 1): (3, 0x3), (0, 2): (4, 0x4), (2, 1): (4, 0x5),
    (0, 3): (5, 0x05), (4, 1): (5, 0x06), (3, 1): (5, 0x07),
    (7, 1): (6, 0x04), (6, 1): (6, 0x05), (1, 2): (6, 0x06),
    (5, 1): (6, 0x07),
    (2, 2): (7, 0x04), (9, 1): (7, 0x05), (0, 4): (7, 0x06),
    (8, 1): (7, 0x07),
    (13, 1): (8, 0x20), (0, 6): (8, 0x21), (12, 1): (8, 0x22),
    (11, 1): (8, 0x23), (3, 2): (8, 0x24), (1, 3): (8, 0x25),
    (0, 5): (8, 0x26), (10, 1): (8, 0x27),
    (16, 1): (10, 0x008), (5, 2): (10, 0x009), (0, 7): (10, 0x00A),
    (2, 3): (10, 0x00B), (1, 4): (10, 0x00C), (15, 1): (10, 0x00D),
    (14, 1): (10, 0x00E), (4, 2): (10, 0x00F),
    (0, 11): (12, 0x010), (8, 2): (12, 0x011), (4, 3): (12, 0x012),
    (0, 10): (12, 0x013), (2, 4): (12, 0x014), (7, 2): (12, 0x015),
    (21, 1): (12, 0x016), (20, 1): (12, 0x017), (0, 9): (12, 0x018),
    (19, 1): (12, 0x019), (18, 1): (12, 0x01A), (1, 5): (12, 0x01B),
    (3, 3): (12, 0x01C), (0, 8): (12, 0x01D), (6, 2): (12, 0x01E),
    (17, 1): (12, 0x01F),
    (10, 2): (13, 0x0010), (9, 2): (13, 0x0011), (5, 3): (13, 0x0012),
    (3, 4): (13, 0x0013), (2, 5): (13, 0x0014), (1, 7): (13, 0x0015),
    (1, 6): (13, 0x0016), (0, 15): (13, 0x0017), (0, 14): (13, 0x0018),
    (0, 13): (13, 0x0019), (0, 12): (13, 0x001A), (26, 1): (13, 0x001B),
    (25, 1): (13, 0x001C), (24, 1): (13, 0x001D), (23, 1): (13, 0x001E),
    (22, 1): (13, 0x001F),
    (0, 31): (14, 0x0010), (0, 30): (14, 0x0011), (0, 29): (14, 0x0012),
    (0, 28): (14, 0x0013), (0, 27): (14, 0x0014), (0, 26): (14, 0x0015),
    (0, 25): (14, 0x0016), (0, 24): (14, 0x0017), (0, 23): (14, 0x0018),
    (0, 22): (14, 0x0019), (0, 21): (14, 0x001A), (0, 20): (14, 0x001B),
    (0, 19): (14, 0x001C), (0, 18): (14, 0x001D), (0, 17): (14, 0x001E),
    (0, 16): (14, 0x001F),
    (0, 40): (15, 0x0010), (0, 39): (15, 0x0011), (0, 38): (15, 0x0012),
    (0, 37): (15, 0x0013), (0, 36): (15, 0x0014), (0, 35): (15, 0x0015),
    (0, 34): (15, 0x0016), (0, 33): (15, 0x0017), (0, 32): (15, 0x0018),
    (1, 14): (15, 0x0019), (1, 13): (15, 0x001A), (1, 12): (15, 0x001B),
    (1, 11): (15, 0x001C), (1, 10): (15, 0x001D), (1, 9): (15, 0x001E),
    (1, 8): (15, 0x001F),
    (1, 18): (16, 0x0010), (1, 17): (16, 0x0011), (1, 16): (16, 0x0012),
    (1, 15): (16, 0x0013), (6, 3): (16, 0x0014), (16, 2): (16, 0x0015),
    (15, 2): (16, 0x0016), (14, 2): (16, 0x0017), (13, 2): (16, 0x0018),
    (12, 2): (16, 0x0019), (11, 2): (16, 0x001A), (31, 1): (16, 0x001B),
    (30, 1): (16, 0x001C), (29, 1): (16, 0x001D), (28, 1): (16, 0x001E),
    (27, 1): (16, 0x001F),
}

ESCAPE_BITS = 22
EOB_CODE, EOB_BITS = 0b10, 2
DC_BITS = 10
EOF_CODE_V2, EOF_BITS = 0x1FF, 10
BS_VERSION_V2 = 2
MAX_LEVEL = 0x200

# islow constants (jfdctint.c), 13-bit fixed point.
_C = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270,
      "0_899": 7373, "1_175": 9633, "1_501": 12299, "1_847": 15137,
      "1_961": 16069, "2_053": 16819, "2_562": 20995, "3_072": 25172}
CONST_BITS, PASS1_BITS = 13, 4


def _round_shift(x, n):
    return (x + (1 << (n - 1))) >> n


def _dct_1d(d, first_pass):
    """One islow pass over the last axis of ``d`` (int64, size 8)."""
    x = [d[..., i] for i in range(8)]
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = [None] * 8
    odd_shift = CONST_BITS - PASS1_BITS if first_pass else \
        CONST_BITS + PASS1_BITS
    if first_pass:
        out[0] = (t10 + t11) << PASS1_BITS
        out[4] = (t10 - t11) << PASS1_BITS
    else:
        out[0] = _round_shift(t10 + t11, PASS1_BITS)
        out[4] = _round_shift(t10 - t11, PASS1_BITS)
    z1 = (t12 + t13) * _C["0_541"]
    out[2] = _round_shift(z1 + t13 * _C["0_765"], odd_shift)
    out[6] = _round_shift(z1 - t12 * _C["1_847"], odd_shift)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _C["1_175"]
    t4 = t4 * _C["0_298"]
    t5 = t5 * _C["2_053"]
    t6 = t6 * _C["3_072"]
    t7 = t7 * _C["1_501"]
    z1 = z1 * -_C["0_899"]
    z2 = z2 * -_C["2_562"]
    z3 = z3 * -_C["1_961"] + z5
    z4 = z4 * -_C["0_390"] + z5
    out[7] = _round_shift(t4 + z1 + z3, odd_shift)
    out[5] = _round_shift(t5 + z2 + z4, odd_shift)
    out[3] = _round_shift(t6 + z2 + z3, odd_shift)
    out[1] = _round_shift(t7 + z1 + z4, odd_shift)
    return torch.stack(out, dim=-1)


def _to_int16(x):
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def fdct_islow(blocks):
    """(..., 8, 8) centred samples -> (..., 8, 8) int64 coefficients: rows
    first, stored as int16, then columns."""
    rows = _to_int16(_dct_1d(blocks.to(torch.int64), True))
    cols = _dct_1d(rows.transpose(-1, -2), False)
    return cols.transpose(-1, -2)


def fdct_float(blocks):
    """The same transform in float32 (the scaled orthonormal DCT, rounded
    to the nearest integer): the control's lower-precision DCT."""
    n = torch.arange(8, dtype=torch.float64, device=blocks.device)
    k = n[:, None]
    m = torch.cos((2 * n[None, :] + 1) * k * torch.pi / 16)
    m[0] /= 2 ** 0.5
    m = (m * 0.5).to(torch.float32)
    x = blocks.to(torch.float32)
    y = m @ x @ m.T
    return torch.round(y * 8).to(torch.int64)


def nv21_blocks(frames, width, height):
    """(F, w*h*3/2) uint8 NV21 frames -> (F, NB, 8, 8) int64 samples
    centred on 128, in mdec.c's encode order."""
    f = frames.shape[0]
    mbx, mby = width // 16, height // 16
    y = frames[:, :width * height].reshape(f, height, width)
    vu = frames[:, width * height:].reshape(f, height // 2, width // 2, 2)
    cr, cb = vu[..., 0], vu[..., 1]

    def chroma(p):      # (F, H/2, W/2) -> (F, mbx, mby, 8, 8)
        return p.reshape(f, mby, 8, mbx, 8).permute(0, 3, 1, 2, 4)

    luma = y.reshape(f, mby, 2, 8, mbx, 2, 8).permute(0, 4, 1, 2, 5, 3, 6)
    blocks = torch.stack([chroma(cr), chroma(cb), luma[:, :, :, 0, 0],
                          luma[:, :, :, 0, 1], luma[:, :, :, 1, 0],
                          luma[:, :, :, 1, 1]], dim=3)
    return blocks.reshape(f, mbx * mby * 6, 8, 8).to(torch.int64) - 128


def _div_round(n, d):
    q = (n.abs() + (d >> 1)) // d
    return torch.where(n < 0, -q, q)


def _clamp_level(q):
    return _to_int16(q).clamp(-MAX_LEVEL, MAX_LEVEL - 2)


def _tables(device):
    """(64, MAX_LEVEL + 1) code lengths and prefix values by (run,
    |level|); a length of 0 marks the escape."""
    bits = torch.zeros((64, MAX_LEVEL + 1), dtype=torch.int64)
    value = torch.zeros((64, MAX_LEVEL + 1), dtype=torch.int64)
    for (run, level), (b, v) in AC_CODES.items():
        bits[run, level] = b + 1
        value[run, level] = v
    return bits.to(device), value.to(device)


def _runs(nonzero):
    """Zero run before each scan position 1..63 (last axis, 63 wide)."""
    pos = torch.arange(1, 64, device=nonzero.device)
    last = torch.where(nonzero, pos, 0).cummax(dim=-1).values
    prev = torch.cat([torch.zeros_like(last[..., :1]), last[..., :-1]], -1)
    return pos - prev - 1


def _ac_levels(ac, scale):
    quant = torch.tensor([QUANT_PSX[z] for z in ZIGZAG[1:]],
                         device=ac.device)
    return _clamp_level(_div_round(ac, quant * scale[..., None, None]))


def _ac_bits(levels, table_bits):
    nz = levels != 0
    run = _runs(nz)
    b = table_bits[run.clamp(max=63), levels.abs()]
    b = torch.where(b == 0, ESCAPE_BITS, b)
    return torch.where(nz, b, 0), nz


def coefficients(frames, width, height, dct=fdct_islow):
    """-> (dc levels (F, NB), AC coefficients in scan order (F, NB, 63))."""
    coef = dct(nv21_blocks(frames, width, height)).flatten(-2)
    dc = _clamp_level(_div_round(coef[..., 0], 16))
    return dc, coef[..., ZIGZAG[1:]]


def choose_scales(ac, budgets):
    """First quant scale in 1..63 at which each frame fits (64 where none
    does) and the AC bits and nonzero levels there."""
    f, nb, _ = ac.shape
    table_bits, _ = _tables(ac.device)
    fixed = nb * (DC_BITS + EOB_BITS) + EOF_BITS
    scale = torch.full((f,), 64, dtype=torch.int64, device=ac.device)
    for s in range(1, 64):
        todo = scale == 64
        if not bool(todo.any()):
            break
        idx = todo.nonzero()[:, 0]
        bits, _ = _ac_bits(_ac_levels(ac[idx], torch.full(
            (len(idx),), s, device=ac.device)), table_bits)
        total = bits.sum(dim=(1, 2)) + fixed
        fits = 8 + 2 * ((total + 15) // 16) <= budgets[idx]
        scale[idx[fits]] = s
    return scale


def _pack(codes, lengths):
    """Codes of ``lengths`` bits (1-D) -> bytes of the 16-bit words they
    fill MSB-first, each word stored little-endian."""
    total = int(lengths.sum())
    sym = torch.repeat_interleave(torch.arange(len(lengths),
                                               device=codes.device), lengths)
    start = torch.cumsum(lengths, 0) - lengths
    k = torch.arange(total, device=codes.device) - start[sym]
    bit = (codes[sym] >> (lengths[sym] - 1 - k)) & 1
    bit = torch.cat([bit, bit.new_zeros((-total) % 16)]).reshape(-1, 16)
    words = (bit << torch.arange(15, -1, -1, device=codes.device)).sum(1)
    return torch.stack([words & 0xFF, words >> 8], 1).reshape(-1), total


def frame_buffer(dc, ac, scale, budget):
    """One frame's buffer (budget bytes, uint8 tensor) at ``scale``, and
    the bytes it uses rounded up to 4 (the STR header's count)."""
    nb = dc.shape[0]
    table_bits, table_value = _tables(ac.device)
    levels = _ac_levels(ac[None], scale.reshape(1))[0]          # (NB, 63)
    bits, nz = _ac_bits(levels, table_bits)
    run = _runs(nz)
    mag = levels.abs()
    esc = bits == ESCAPE_BITS
    vlc = (table_value[run.clamp(max=63), mag] << 1) | (levels < 0).long()
    escape = (1 << 16) | (run << 10) | (levels & 0x3FF)
    code = torch.where(esc, escape, vlc)
    sym_codes = torch.cat([(dc & 0x3FF)[:, None], code,
                           torch.full((nb, 1), EOB_CODE, device=ac.device)],
                          1).reshape(-1)
    sym_bits = torch.cat([torch.full((nb, 1), DC_BITS, device=ac.device),
                          bits, torch.full((nb, 1), EOB_BITS,
                                           device=ac.device)], 1).reshape(-1)
    keep = sym_bits > 0
    sym_codes = torch.cat([sym_codes[keep],
                           torch.tensor([EOF_CODE_V2], device=ac.device)])
    sym_bits = torch.cat([sym_bits[keep],
                          torch.tensor([EOF_BITS], device=ac.device)])
    payload, total = _pack(sym_codes, sym_bits)
    n_nonzero = int(nz.sum())
    half_words = (n_nonzero + 2 * nb + 2 + 0x3F) & ~0x3F
    blocks_used = (half_words + 1) >> 1
    s = int(scale)
    header = torch.tensor([blocks_used & 0xFF, blocks_used >> 8, 0x00, 0x38,
                           s & 0xFF, s >> 8, BS_VERSION_V2, 0x00],
                          device=ac.device)
    out = torch.zeros(int(budget), dtype=torch.uint8, device=ac.device)
    body = torch.cat([header, payload]).to(torch.uint8)
    if len(body) > len(out):
        raise ValueError("the frame's bitstream overruns its budget")
    out[:len(body)] = body
    return out, (8 + 2 * ((total + 15) // 16) + 3) & ~3


def encode_frames(frames, budgets, width, height, dct=fdct_islow):
    """(F, w*h*3/2) uint8 NV21 frames and (F,) budgets -> (list of F
    uint8 buffers, (F,) quant scales, list of F bytes used). A frame that
    fits no scale gets scale 64 and an empty buffer (mdec.c refuses
    it)."""
    budgets = budgets.to(torch.int64)
    dc, ac = coefficients(frames, width, height, dct)
    scale = choose_scales(ac, budgets)
    out, used = [], []
    for j in range(frames.shape[0]):
        if int(scale[j]) == 64:
            out.append(torch.zeros(0, dtype=torch.uint8, device=ac.device))
            used.append(0)
        else:
            buf, n = frame_buffer(dc[j], ac[j], scale[j], budgets[j])
            out.append(buf)
            used.append(n)
    return out, scale, used


def frame_work(frames, width, height, scales):
    """Per-frame census at the given scales: (nonzero AC levels, blocks
    over 256 bits, nonzero levels in those blocks), each (F,)."""
    table_bits, _ = _tables(frames.device)
    dc, ac = coefficients(frames, width, height)
    del dc
    bits, nz = _ac_bits(_ac_levels(ac, scales.to(torch.int64)), table_bits)
    block_bits = bits.sum(-1) + DC_BITS + EOB_BITS
    long = block_bits > 256
    return (nz.sum(dim=(1, 2)), long.sum(1),
            (nz.sum(-1) * long).sum(1))
