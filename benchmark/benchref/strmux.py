"""Plain reference of psxavenc -t str with audio: the .str file, 2,336-byte
Mode 2 sectors, as filefmt.c (encode_file_str), mdec.c
(encode_sector_str) and libpsxav (adpcm.c's XA sectors, cdrom.c's EDC)
write it, in plain NumPy and PyTorch.

- Ingest: source frames at the AVI's rate go onto the output's frame
  grid as decoding.c:408-478 does in doubles: a frame late for its slot
  is dropped, a gap is filled with copies of the last frame.
- The schedule: of every ``interleave`` sectors the first is audio, the
  others video; a frame takes the whole sectors its running remainder of
  75 x speed x video-sectors / (interleave x fps) gives it; the input ends
  when no more than a sector of audio, or two frames, are left.
- Video sectors: the subheader, the 32-byte STR header (chunk, frame,
  bytes used, size and the frame's 8-byte BS header) and 2,016 bytes of
  the frame's buffer (``bs.py``), then the Form 1 EDC over 0x10-0x817 at
  0x818, computed on the buffer as if it were a 2,352-byte sector.
- Audio sectors: 18 sound groups of 128 bytes of XA-ADPCM (4 filters,
  ``adpcm.py``; stereo 4-bit: four units of each channel a group, left in
  the low nibbles), the subheader with the coding byte ORed in, the EDC
  over 0x000-0x91B at 0x91C, then the EOF flag on the last sector.
- One 2,352-byte buffer serves every sector and is never cleared: bytes
  a sector does not write keep the last sector's.

This file imports nothing of the program under test.
"""

import math

import numpy as np
import torch

from . import adpcm, bs

PAYLOAD = 2016
SECTOR = 2336
STR_MAGIC = 0x0160
VIDEO_ID = 0x8001
SUBMODE_VIDEO = 0x48          # DATA | RT
SUBMODE_AUDIO = 0x64          # AUDIO | FORM2 | RT
SUBMODE_EOF = 0x80
XA_FILTERS, XA_GROUPS = 4, 18
HEADER_POS = (0, 1, 2, 3, 8, 9, 10, 11)


def _edc_table():
    table = []
    for i in range(256):
        v = i
        for _ in range(8):
            v = (v >> 1) ^ (0xD8018001 if v & 1 else 0)
        table.append(v)
    return table


EDC_TABLE = _edc_table()


def edc(data):
    """cdrom.c's EDC: reflected CRC-32, polynomial 0xD8018001, zero init,
    no final xor."""
    crc, t = 0, EDC_TABLE
    for b in bytes(data):
        crc = (crc >> 8) ^ t[(crc ^ b) & 0xFF]
    return crc


def retime(n_frames, src_num, src_den, fps_num, fps_den):
    """Source frame index of each output frame on the constant grid."""
    out = []
    step = fps_den / fps_num
    next_pts = 0.0
    for i in range(n_frames):
        pts = i * src_den / src_num
        if out and pts < next_pts:
            continue
        if not out:
            next_pts = pts
        else:
            next_pts += step
        for _ in range(max(0, math.ceil((pts - next_pts) / step))):
            out.append(out[-1])
            next_pts += step
        out.append(i)
    return out


def schedule(cfg, audio_values, video_frames):
    """-> (sectors, audio lengths, frame budgets): each sector a dict with
    ``video`` and either (frame, chunk, chunks, offset) or (length, audio
    index, eoi). ``audio_values`` counts samples of all channels."""
    ch = cfg["audio_channels"]
    n = 2 if ch == 2 else 4
    if cfg["audio_frequency"] == 18900:
        n <<= 1
    if cfg["audio_bit_depth"] == 4:
        n <<= 1
    interleave = n * cfg["cd_speed"]
    per_sector = ((112 if cfg["audio_bit_depth"] == 8 else 224)
                  >> (1 if ch == 2 else 0)) * XA_GROUPS
    vspb = interleave - 1
    num = 75 * cfg["cd_speed"] * vspb * cfg["fps_den"]
    den = interleave * cfg["fps_num"]
    frames_needed = max(2, -(-vspb * den // num))
    avail_a, avail_v = audio_values, video_frames
    eoi, acc, frame_max, offset, frame = False, 0, 0, 0, 0
    sectors, lengths, budgets = [], [], []
    sc = 0
    while not eoi or offset < frame_max:
        if not eoi and ((per_sector * ch and avail_a <= per_sector * ch)
                        or avail_v <= frames_needed):
            eoi = True
        if sc % interleave > 0:
            used = 0
            while offset >= frame_max:
                frame += 1
                acc += num
                frame_max = acc // den * PAYLOAD
                acc %= den
                offset = 0
                budgets.append(frame_max)
                used += 1
            sectors.append({"video": True, "frame": frame,
                            "chunk": offset // PAYLOAD,
                            "chunks": frame_max // PAYLOAD,
                            "offset": offset})
            offset += PAYLOAD
            avail_v -= used
        else:
            ln = min(avail_a // ch, per_sector)
            if ln:
                lengths.append(ln)
            sectors.append({"video": False, "length": ln,
                            "audio": len(lengths) - 1, "eoi": eoi})
            avail_a -= ln * ch
        sc += 1
    return sectors, lengths, budgets


def xa_payloads(pcm, lengths, device, rounds=None):
    """(n, 2) int16 PCM and the sectors' per-channel lengths -> (S, 2304)
    uint8 stereo 4-bit XA payloads, the ADPCM state carried over the
    whole file."""
    ch = pcm.shape[1]
    upb = 4                                   # units a channel a group
    per = XA_GROUPS * upb                     # units a channel a sector
    s = len(lengths)
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    k = 28 * np.arange(per, dtype=np.int64)
    offsets = (start[:, None] + k[None, :]).reshape(-1)
    limits = (np.asarray(lengths)[:, None] - k[None, :]).reshape(-1)
    x = torch.as_tensor(pcm.astype(np.int64), device=device)
    idx = torch.as_tensor(offsets, device=device)[:, None] + \
        torch.arange(28, device=device)
    units, lim, first = [], [], []
    for c in range(ch):
        col = torch.cat([x[:, c], x.new_zeros(28 * per)])
        units.append(col[idx.clamp(max=len(col) - 1)])
        lim.append(torch.as_tensor(limits, device=device))
        f = torch.zeros(len(offsets), dtype=torch.bool, device=device)
        f[0] = True
        first.append(f)
    h, nib = adpcm.encode_streams(torch.cat(units), torch.cat(lim),
                                  torch.cat(first), rounds=rounds,
                                  filters=XA_FILTERS)
    h = h.reshape(ch, s, XA_GROUPS, upb).cpu().numpy()
    nib = nib.reshape(ch, s, XA_GROUPS, upb, 28).cpu().numpy()
    blk = np.zeros((s, XA_GROUPS, 128), np.int64)
    for j in range(upb):
        for c in range(ch):
            blk[:, :, HEADER_POS[2 * j + c]] = h[c, :, :, j]
        pos = 0x10 + j + 4 * np.arange(28)
        blk[:, :, pos] = (nib[0, :, :, j] & 0xF) | (nib[1, :, :, j] << 4)
    blk[:, :, 4:8] = blk[:, :, 0:4]
    blk[:, :, 12:16] = blk[:, :, 8:12]
    return blk.reshape(s, XA_GROUPS * 128).astype(np.uint8)


def str_file(cfg, frames_nv21, pcm, device, src_fps=(15, 1),
             dct=bs.fdct_islow, rounds=None):
    """The bytes of the .str file of an AVI's NV21 frames (F, w*h*3/2) at
    ``src_fps`` (num, den) and its (n, 2) int16 PCM under ``cfg``."""
    w, h = cfg["width"], cfg["height"]
    grid = retime(len(frames_nv21), src_fps[0], src_fps[1], cfg["fps_num"],
                  cfg["fps_den"])
    sectors, lengths, budgets = schedule(cfg, pcm.size, len(grid))
    # Encoded frame k (from 1) shows grid frame k - 1, the last one once
    # the input has ended (decoding.c:524-531).
    src = [grid[min(k, len(grid)) - 1] for k in range(1, len(budgets) + 1)]
    bufs, scales, used = [], [], []
    for lo in range(0, len(budgets), 16):
        f = torch.as_tensor(frames_nv21[src[lo:lo + 16]], device=device)
        b, sc, u = bs.encode_frames(
            f, torch.tensor(budgets[lo:lo + 16], device=device), w, h,
            dct=dct)
        bufs += [x.cpu().numpy() for x in b]
        scales += sc.tolist()
        used += u
    if max(scales, default=0) >= 64:
        raise ValueError("a frame fits no quant scale")
    payloads = xa_payloads(pcm, lengths, device, rounds=rounds)
    coding = (1 if cfg["audio_channels"] == 2 else 0) | \
        (4 if cfg["audio_frequency"] == 18900 else 0) | \
        (16 if cfg["audio_bit_depth"] == 8 else 0)
    buf = np.zeros(2352, np.uint8)
    out = bytearray()
    for d in sectors:
        if d["video"]:
            fb = bufs[d["frame"] - 1]
            buf[0:4] = (0, 0, SUBMODE_VIDEO, 0)
            buf[4:8] = buf[0:4]
            hdr = np.zeros(32, np.uint8)
            hdr[0:8] = np.frombuffer(np.array(
                [STR_MAGIC, VIDEO_ID, d["chunk"], d["chunks"]],
                "<u2").tobytes(), np.uint8)
            hdr[8:16] = np.frombuffer(np.array(
                [d["frame"], used[d["frame"] - 1]], "<u4").tobytes(),
                np.uint8)
            hdr[16:20] = np.frombuffer(np.array([w, h], "<u2").tobytes(),
                                       np.uint8)
            hdr[20:28] = fb[:8]
            buf[8:40] = hdr
            buf[40:40 + PAYLOAD] = fb[d["offset"]:d["offset"] + PAYLOAD]
            buf[0x818:0x81C] = np.frombuffer(
                edc(buf[0x10:0x818]).to_bytes(4, "little"), np.uint8)
        elif d["length"]:
            buf[0:3] = (0, 0, SUBMODE_AUDIO)
            buf[3] |= coding
            buf[4:8] = buf[0:4]
            buf[8:8 + 2304] = payloads[d["audio"]]
            buf[0x91C:0x920] = np.frombuffer(
                edc(buf[0:0x91C]).to_bytes(4, "little"), np.uint8)
            if d["eoi"]:
                buf[2] |= SUBMODE_EOF
                buf[6] |= SUBMODE_EOF
        out += buf[:SECTOR].tobytes()
    return bytes(out)
