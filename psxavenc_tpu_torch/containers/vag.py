"""SPU-ADPCM containers: raw .spu, .vag, interleaved .spui/.vagi.

Counterpart of ``psxavenc_tpu/containers/vag.py``, byte-compatible with
psxavenc/filefmt.c:212-389 (encode_file_spu, encode_file_spui) and
write_vag_header (filefmt.c:95-162). The ADPCM units of each chunk encode
in one K5 call on the device. ``unit_encoder`` takes the place of
``streams.encode_unit_streams`` (the batch runner's injection point): a
non-chunked one gets the whole file in one call, a ``chunked`` one the
bounded chunk feed.
"""

import os

import numpy as np

from .. import cli_args as ca
from ..models import adpcm_stream as streams
from ..ops import adpcm as ops
from ..utils.progress import Progress

VAG_HEADER_SIZE = 0x30
BLOCK_SIZE = 16
SAMPLES_PER_BLOCK = 28

LOOP_END = 1
LOOP_REPEAT = 3
LOOP_START = 6
LOOP_TRAP = 5


def write_vag_header(args, size_per_channel):
    """filefmt.c:95-162."""
    h = bytearray(VAG_HEADER_SIZE)
    h[0:3] = b"VAG"
    h[3] = ord("i") if args.format == ca.FORMAT_VAGI else ord("p")
    h[4:8] = (0x20).to_bytes(4, "big")  # version
    if args.format == ca.FORMAT_VAGI:
        h[0x08:0x0C] = (args.audio_interleave & 0xFFFFFFFF).to_bytes(
            4, "little")
    h[0x0C:0x10] = (size_per_channel & 0xFFFFFFFF).to_bytes(4, "big")
    h[0x10:0x14] = (args.audio_frequency & 0xFFFFFFFF).to_bytes(4, "big")
    if args.format == ca.FORMAT_VAGI and args.audio_loop_point >= 0:
        loop_start_block = (args.audio_loop_point * args.audio_frequency) \
            // (SAMPLES_PER_BLOCK * 1000)
        if not (args.flags & ca.FLAG_SPU_NO_LEADING_DUMMY):
            loop_start_block += 1
        loop_point = loop_start_block * BLOCK_SIZE
        h[0x14:0x18] = (loop_point & 0xFFFFFFFF).to_bytes(4, "big")
    h[0x1E] = args.audio_channels & 0xFF
    name = os.path.basename(args.output_file.replace("\\", "/"))
    h[0x20:0x20 + min(16, len(name))] = name.encode("utf-8",
                                                    "replace")[:16]
    return bytes(h)


# SPU blocks per device call in the chunked feeds: bounds the working set
# (~1.8M samples = 3.7 MB PCM per chunk) while keeping typical files in
# one call.
SPU_CHUNK_BLOCKS = 65536


def encode_file_spu(args, dec, output, device, unit_encoder=None):
    """Mono SPU-ADPCM -> raw .spu or .vag (filefmt.c:212-293)."""
    from ..io import ingest

    if unit_encoder is None:
        unit_encoder = streams.encode_unit_streams

    if args.format == ca.FORMAT_VAG:
        output.seek(VAG_HEADER_SIZE)

    block_count = 0
    if not (args.flags & ca.FLAG_SPU_NO_LEADING_DUMMY):
        output.write(bytes(BLOCK_SIZE))
        block_count += 1

    loop_start_block = -1
    if args.audio_loop_point >= 0:
        loop_start_block = block_count + \
            (args.audio_loop_point * args.audio_frequency) \
            // (SAMPLES_PER_BLOCK * 1000)

    # Drive the windowing state machine (counts only) to reproduce
    # per-block flags; samples pull in chunks from the source. Bulk
    # drain: the per-block Python loop cost ~25x the actual encode.
    source = ingest.source_for(dec)
    block_lens, block_eois = ingest.drain_audio_blocks(
        dec, SAMPLES_PER_BLOCK)

    group = len(block_lens) if streams.whole_file(unit_encoder) \
        else SPU_CHUNK_BLOCKS
    progress = Progress(args)
    quiet = bool(args.flags & ca.FLAG_HIDE_PROGRESS)
    prev1 = prev2 = None
    base = 0
    while base < len(block_lens):
        lens = block_lens[base:base + group]
        eois = block_eois[base:base + group]
        pcm = source.take_audio(int(lens.sum()))
        offsets, limits = streams.chunk_unit_layout(lens)
        headers, nibbles, prev1, prev2 = unit_encoder(
            pcm.astype(np.int32)[None, :], offsets[None], limits[None],
            ops.SPU_FILTER_COUNT, ops.SHIFT_RANGE_4BPS, prev1=prev1,
            prev2=prev2, device=device)
        flags = np.zeros(len(lens), dtype=np.uint8)
        if args.flags & ca.FLAG_SPU_ENABLE_LOOP:
            flags[eois] |= LOOP_REPEAT
        ls = loop_start_block - block_count
        if 0 <= ls < len(lens):
            flags[ls] |= LOOP_START
        blocks = streams.pack_spu_blocks(headers[0], nibbles[0], flags)
        output.write(blocks.tobytes())
        if quiet:
            block_count += blocks.shape[0]
        else:
            for _ in range(blocks.shape[0]):
                # Pre-increment counter, like the reference's
                # for-increment (filefmt.c:237,259-268).
                progress.print_spu(block_count, args.audio_frequency)
                block_count += 1
        base += len(lens)

    if not (args.flags & ca.FLAG_SPU_ENABLE_LOOP):
        trap = bytearray(BLOCK_SIZE)
        trap[1] = LOOP_TRAP
        output.write(bytes(trap))
        block_count += 1

    overflow = (block_count * BLOCK_SIZE) % args.alignment
    if overflow:
        output.write(bytes(args.alignment - overflow))

    if args.format == ca.FORMAT_VAG:
        output.seek(0)
        output.write(write_vag_header(args, block_count * BLOCK_SIZE))
    if hasattr(dec, "close"):
        dec.close()


def encode_file_spui(args, dec, output, device, unit_encoder=None):
    """Interleaved SPU-ADPCM -> .spui or .vagi (filefmt.c:295-389)."""
    if unit_encoder is None:
        unit_encoder = streams.encode_unit_streams
    ch = args.audio_channels
    samples_per_chunk = (args.audio_interleave // BLOCK_SIZE) * \
        SAMPLES_PER_BLOCK
    chunk_size = args.audio_interleave * ch + args.alignment - 1
    chunk_size -= chunk_size % args.alignment
    header_size = VAG_HEADER_SIZE + args.alignment - 1
    header_size -= header_size % args.alignment

    if args.format == ca.FORMAT_VAGI:
        output.seek(header_size)
    elif args.audio_loop_point >= 0 and not (args.flags & ca.FLAG_QUIET):
        import sys
        print("Warning: ignoring loop point as there is no header to store "
              "it in", file=sys.stderr)

    # Windowing pass (counts only): per-chunk lengths and end_of_input.
    from ..io import ingest

    source = ingest.source_for(dec)
    chunks = []
    first = True
    while dec.ensure_av_data(samples_per_chunk * ch, 0):
        ln = min(dec.audio_sample_count // ch, samples_per_chunk)
        dummy = first and not (args.flags & ca.FLAG_SPU_NO_LEADING_DUMMY)
        if dummy:
            ln -= SAMPLES_PER_BLOCK
        chunks.append((ln, dummy, dec.end_of_input))
        dec.retire_av_data(ln * ch, 0)
        first = False

    units_per_chunk = max(1, samples_per_chunk // SAMPLES_PER_BLOCK)
    group = max(1, len(chunks)) if streams.whole_file(unit_encoder) else \
        max(1, SPU_CHUNK_BLOCKS // units_per_chunk)
    progress = Progress(args)
    prev1 = prev2 = None
    for gbase in range(0, len(chunks), group):
        part = chunks[gbase:gbase + group]
        pcm = source.take_audio(int(sum(ln for ln, _, _ in part)) * ch)
        per_channel = np.stack([pcm[c::ch] for c in range(ch)]) \
            if ch > 1 else pcm[None, :]
        offsets, limits = streams.chunk_unit_layout(
            [ln for ln, _, _ in part])
        headers, nibbles, prev1, prev2 = unit_encoder(
            per_channel.astype(np.int32),
            np.broadcast_to(offsets, (ch,) + offsets.shape),
            np.broadcast_to(limits, (ch,) + limits.shape),
            ops.SPU_FILTER_COUNT, ops.SHIFT_RANGE_4BPS, prev1=prev1,
            prev2=prev2, device=device)
        blocks = [streams.pack_spu_blocks(headers[c], nibbles[c])
                  for c in range(ch)]
        unit_pos = 0
        for ci, (ln, dummy, eoi) in enumerate(part):
            n_units = (ln + SAMPLES_PER_BLOCK - 1) // SAMPLES_PER_BLOCK
            chunk = np.zeros(chunk_size, dtype=np.uint8)
            base = BLOCK_SIZE if dummy else 0
            for c in range(ch):
                dst = c * args.audio_interleave + base
                length = n_units * BLOCK_SIZE
                if length > 0:
                    chunk[dst:dst + length] = \
                        blocks[c][unit_pos:unit_pos + n_units].reshape(-1)
                    last = dst + length - BLOCK_SIZE
                    if (args.flags & ca.FLAG_SPU_ENABLE_LOOP) or \
                            (eoi and args.audio_loop_point >= 0):
                        chunk[last + 1] = LOOP_REPEAT
                    elif eoi:
                        # filefmt.c:352-357: zero-fill and repurpose the
                        # last block as the loop trap.
                        chunk[last:last + BLOCK_SIZE] = 0
                        chunk[last + 1] = LOOP_TRAP
            unit_pos += n_units
            output.write(chunk.tobytes())
            # Pre-increment counter (filefmt.c:364-374).
            progress.print_spui(gbase + ci, samples_per_chunk,
                                args.audio_frequency)

    if args.format == ca.FORMAT_VAGI:
        header = bytearray(header_size)
        header[:VAG_HEADER_SIZE] = write_vag_header(
            args, len(chunks) * args.audio_interleave)
        output.seek(0)
        output.write(bytes(header))
    if hasattr(dec, "close"):
        dec.close()
