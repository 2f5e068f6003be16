"""BS bitstream packing on torch tensors.

Counterpart of ``psxavenc_tpu/ops/bitpack.py``:

- ``pack_bits``, the flat per-symbol packer, exact for any stream;
- ``pack_frames_blocks``, the per-block packer: symbols pack densely into
  private 16-word block streams (``_pack_block_streams``, or K10), then
  each stream is placed at its global offset (``_place_streams``, or
  K9). Frames with a block over the 256-bit window take ``pack_bits``.

Bit order matches the reference packer (mdec.c:321-333): 16-bit groups
filled MSB-first, stored as little-endian byte pairs. Unsigned 32-bit
values are held in int64 and masked, since torch's ``>>`` on int32 is
arithmetic.
"""

import torch

BLOCK_CAP_WORDS = 16  # per-block stream capacity (256 bits)

U32_MASK = 0xFFFFFFFF


def _shl(x, n):
    return torch.bitwise_left_shift(x, n)


def pack_bits(codes, bits, *, capacity_words):
    """Pack symbol streams into 16-bit words, the exact flat packer.

    codes: (R, S) int64 right-aligned code values; bits: (R, S) bit
    lengths (0 = skip). Returns (words (R, capacity_words) int64 holding
    u16 values, total_bits (R,) int64). Bits past the capacity drop.
    """
    bits = bits.to(torch.int64)
    offsets = torch.cumsum(bits, dim=1) - bits
    return (pack_bits_at(codes, bits, offsets, capacity_words=capacity_words),
            offsets[:, -1] + bits[:, -1])


def pack_bits_at(codes, bits, offsets, *, capacity_words):
    """:func:`pack_bits` at given bit offsets: (R, S) codes of ``bits``
    bits (0 = skip, at most 32) whose first bit sits at ``offsets``, with
    no two of them sharing a bit -> (R, capacity_words) int64 u16 words."""
    codes = codes.to(torch.int64)
    bits = bits.to(torch.int64)
    offsets = offsets.to(torch.int64)
    R = codes.shape[0]
    end = offsets + bits

    # One spare column collects dropped writes.
    words = torch.zeros((R, capacity_words + 1), dtype=torch.int64,
                        device=codes.device)
    w0 = offsets >> 4
    one = torch.ones_like(codes)
    for part in range(3):
        w = w0 + part
        win_start = w << 4
        win_end = win_start + 16
        # Overlap of [offset, end) with this word's bit window; the code's
        # LSB sits at global bit end-1.
        lo = torch.maximum(offsets, win_start)
        hi = torch.minimum(end, win_end)
        n = hi - lo
        valid = (n > 0) & (bits > 0)
        rsh = (end - hi).clamp(0, 31)
        nbits = n.clamp(0, 31)
        chunk = (codes >> rsh) & (_shl(one, nbits) - 1)
        lsh = (win_end - hi).clamp(0, 31)
        val = torch.where(valid, _shl(chunk, lsh) & U32_MASK, 0)
        idx = torch.where(valid & (w < capacity_words), w, capacity_words)
        # Bit ranges are disjoint, so add == or.
        words.scatter_add_(1, idx, val)
    return words[:, :capacity_words]


def streams_to_u32(streams, goff):
    """Per-block placed u32 values: shift each block's 16-word MSB-first
    stream to its global sub-word offset, even-align it and pack
    little-endian u16 pairs.

    streams: (..., NBe, 16) u16 values; goff: (..., NBe) global bit
    offsets. Returns (vals32 (..., NBe, 9) int64 u32 values, e0 (..., NBe)
    int64 u32-word offsets, monotone along the block axis).
    """
    s = streams.to(torch.int64)
    sh = (goff & 15).to(torch.int64)[..., None]
    s_prev = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    # Stream bits [16i - sh, 16(i+1) - sh) form contrib word i; sh == 0
    # makes the << 16 term vanish under the & 0xFFFF mask.
    c_main = (s >> sh) | (_shl(s_prev, 16 - sh) & 0xFFFF)
    c_tail = _shl(s[..., -1:], 16 - sh) & 0xFFFF
    contrib = torch.cat([c_main, c_tail], dim=-1)
    w0 = goff >> 4
    zcol = torch.zeros_like(contrib[..., :1])
    shifted = torch.where(((w0 & 1) == 1)[..., None],
                          torch.cat([zcol, contrib], dim=-1),
                          torch.cat([contrib, zcol], dim=-1))
    pairs = shifted.reshape(shifted.shape[:-1] + (9, 2))
    vals32 = pairs[..., 0] | (pairs[..., 1] << 16)
    return vals32, (goff >> 5).to(torch.int64)


def or_scatter(n, idx, val):
    """(n,) int64: the OR of the u32 values ``val`` at the word indices
    ``idx`` (int64, one shape), bit plane by bit plane."""
    out = torch.zeros(n, dtype=torch.int64, device=val.device)
    for bit in range(32):
        plane = torch.zeros(n, dtype=torch.int64, device=val.device)
        plane.scatter_reduce_(0, idx, (val >> bit) & 1, "amax")
        out |= plane << bit
    return out


def cap32_of(capacity_words):
    """u32 words that hold ``capacity_words`` u16 words."""
    return (capacity_words + 1) // 2


def with_eof_block(streams, block_bits, eof):
    """Append the end-of-frame block to (B, NB, 16) streams and (B, NB)
    block bits: a lone 10-bit code ``eof`` at the top of stream word 0."""
    B = streams.shape[0]
    eof_stream = torch.zeros((B, 1, streams.shape[2]), dtype=streams.dtype,
                             device=streams.device)
    # fill_ with a Python number: item assignment would make a CPU scalar
    # tensor and read it back with item() on every call.
    eof_stream[:, 0, 0].fill_(eof << 6)
    ten = torch.full((B, 1), 10, dtype=block_bits.dtype,
                     device=block_bits.device)
    return (torch.cat([streams, eof_stream], dim=1),
            torch.cat([block_bits, ten], dim=1))


def _pack_block_streams(codes, bits, offs, *, bcap):
    """Dense per-block packing: (NBe, S) symbols with in-block offsets
    ``offs`` -> (NBe, bcap) int64 u16 values. Word w of a block holds its
    bits [16w, 16w + 16), MSB-first; bits past 16 * bcap are cut."""
    codes = codes.to(torch.int64) & U32_MASK
    bits = bits.to(torch.int64)
    offs = offs.to(torch.int64)
    ws = _shl(torch.arange(bcap, dtype=torch.int64, device=codes.device),
              4)[None, :]
    acc = torch.zeros((codes.shape[0], bcap), dtype=torch.int64,
                      device=codes.device)
    for i in range(codes.shape[1]):
        o = offs[:, i:i + 1]
        end = o + bits[:, i:i + 1]
        hi = torch.minimum(end, ws + 16)
        n = hi - torch.maximum(o, ws)
        rsh = (end - hi).clamp(0, 31)
        nbits = n.clamp(0, 31)
        chunk = (codes[:, i:i + 1] >> rsh) & (_shl(torch.ones_like(nbits),
                                                    nbits) - 1)
        lsh = (ws + 16 - hi).clamp(0, 31)
        acc |= torch.where(n > 0, _shl(chunk, lsh) & U32_MASK, 0)
    return acc


def _place_streams_u32(streams, goff, *, capacity_words):
    """The placed u32 words of :func:`_place_streams`: (B, NBe, bcap) u16
    streams at (B, NBe) global bit offsets -> (B, cap32) int64 u32 words.
    Each block's bcap/2 + 1 placed u32 words add at its u32 offset;
    adjacent blocks' bits are disjoint, so add == or. Words at or past
    cap32 drop."""
    B = streams.shape[0]
    vals32, e0 = streams_to_u32(streams, goff)
    cap32 = cap32_of(capacity_words)
    idx = (e0[..., None] + torch.arange(vals32.shape[-1],
                                        device=vals32.device)).clamp(
        max=cap32)
    out = torch.zeros((B, cap32 + 1), dtype=torch.int64,
                      device=vals32.device)
    out.scatter_add_(1, idx.reshape(B, -1), vals32.reshape(B, -1))
    return out[:, :cap32]


def _place_streams(streams, goff, *, capacity_words):
    """Word-granular ragged concat of per-block streams (psxavenc_tpu's
    ``_place_streams``, there applied per frame): (B, NBe, bcap) u16
    streams at (B, NBe) global bit offsets -> (B, capacity_words) int64
    u16 words, the little-endian halves of :func:`_place_streams_u32`'s
    words. Words at or past the capacity drop."""
    out32 = _place_streams_u32(streams, goff, capacity_words=capacity_words)
    words = torch.stack([out32 & 0xFFFF, out32 >> 16], dim=-1)
    return words.reshape(streams.shape[0], -1)[:, :capacity_words]


def pack_frames_blocks(codes, bits, *, capacity_words,
                       bcap=BLOCK_CAP_WORDS, kernel_place=False,
                       kernel_pack=False):
    """Pack a batch of per-block symbol streams into frame bitstreams.

    codes: (B, NBe, S) u32 code values (int64 or int32 bit patterns);
    bits: (B, NBe, S) bit lengths, 0 to 32 (0 = skip). Symbols pack into
    bcap-word block streams (``_pack_block_streams``, or K10
    ``bitpack_cuda.pack_block_streams`` with ``kernel_pack``, whose block
    bit counts are used as they come), then the streams are placed
    (``_place_streams``, or K9 ``bitpack_cuda.place_streams`` with
    ``kernel_place``). A frame with a
    block over 16 * bcap bits is packed by :func:`pack_bits` instead
    (psxavenc_tpu sends its whole batch there; every frame's words are
    the same either way). That flat path stays here: this packer takes
    symbols, not the coefficients that the ``fused*`` packers' tail
    emission (``bs_cuda.emit_tail``) works from.

    Returns (words (B, capacity_words) int32 u16 values, total_bits (B,)
    int32), as :func:`pack_bits` on each frame's flattened symbols.
    """
    from . import bitpack_cuda

    B, nbe, S = codes.shape
    if kernel_pack:
        if bcap != BLOCK_CAP_WORDS:
            raise ValueError("pack_frames_blocks: the kernel packs "
                             f"{BLOCK_CAP_WORDS}-word block streams")
        streams, block_bits = bitpack_cuda.pack_block_streams(codes, bits)
        block_bits = block_bits.to(torch.int64)
    else:
        bits64 = bits.to(torch.int64)
        offs = torch.cumsum(bits64, dim=2) - bits64
        block_bits = offs[..., -1] + bits64[..., -1]
        streams = _pack_block_streams(
            codes.reshape(-1, S), bits64.reshape(-1, S), offs.reshape(-1, S),
            bcap=bcap).reshape(B, nbe, bcap)
    goff = torch.cumsum(block_bits, dim=1) - block_bits
    total_bits = goff[:, -1] + block_bits[:, -1]
    if kernel_place:
        words = bitpack_cuda.place_streams(
            streams.to(torch.int32), goff.to(torch.int32),
            total_bits.to(torch.int32), capacity_words=capacity_words)
    else:
        words = _place_streams(streams, goff,
                               capacity_words=capacity_words).to(torch.int32)
    idx = torch.nonzero((block_bits > 16 * bcap).any(dim=1))[:, 0]
    if idx.numel():
        words[idx] = pack_bits(codes[idx].reshape(len(idx), -1),
                               bits[idx].reshape(len(idx), -1),
                               capacity_words=capacity_words)[0].to(
            torch.int32)
    return words, total_bits.to(torch.int32)


def pack_bits_blocks(codes, bits, *, capacity_words, bcap=BLOCK_CAP_WORDS):
    """Single-frame wrapper over :func:`pack_frames_blocks`."""
    words, total_bits = pack_frames_blocks(
        codes[None], bits[None], capacity_words=capacity_words, bcap=bcap)
    return words[0], total_bits[0]


def words_to_bytes(words):
    """(W,) u16-valued ints -> (2W,) uint8 little-endian pairs."""
    w = words.to(torch.int64) & 0xFFFF
    return torch.stack([w & 0xFF, w >> 8], dim=-1).reshape(-1).to(
        torch.uint8)


def u32_to_i32(x):
    """int64 holding u32 values -> int32 with the same bit pattern."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u16_values(out32, capacity_words):
    """(B, cap32) int32 placed u32 words -> (B, capacity_words) int32 u16
    values (the word form of psxavenc_tpu's packers)."""
    return words_u16(out32, capacity_words).to(torch.int32) & 0xFFFF


def u16_to_i16(words):
    """u16 values in any integer dtype -> int16 with the same bits."""
    return (((words & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def words_u16(out32, capacity_words):
    """(B, cap32) int32 placed words -> (B, capacity_words) int16 view of
    the little-endian u16 payload (the on-disk byte order; read it as
    uint16 on the host)."""
    return out32.view(torch.int16)[:, :capacity_words]
