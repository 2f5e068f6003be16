"""Plain reference of psxavenc -t xa at its defaults: the .xa file of a
44,100 Hz stereo s16 master, as decoding.c (libswresample), filefmt.c
(encode_file_xa, filefmt.c:167-210) and libpsxav (adpcm.c's XA sectors,
adpcm.c:193-354; cdrom.c's EDC) write it, in plain PyTorch.

- The resampler: libswresample's integer polyphase FIR from 44,100 to
  37,800 Hz, ``y[n] = clip16((sum_k T[n][k] * x[start_n + k] + 16384) >>
  15)``, with no flush at the end of the input (the filter's delay is
  dropped). The one bank it needs is a copy kept beside this file
  (``swr_44100_37800.json``).
- The sectors: each takes ``min(left, 2016)`` samples a channel (18 sound
  groups of 4 units of 28 samples a channel), the ADPCM state carried
  over the whole file; their payloads are ``strmux.xa_payloads``' (the
  segmented ADPCM of ``adpcm.py``).
- The 2,336-byte sector: the subheader ``00 00 64 01`` (file 0, channel
  0, AUDIO | FORM2 | RT, stereo 37,800 Hz 4-bit) twice, the payload at 8,
  the EDC over 0x000-0x91B at 0x91C, and last the EOF flag (0x80 in both
  submode bytes) of the last sector, after its EDC. The muxer's one
  buffer is never cleared, but every sector writes the same bytes of it
  and none writes 0x908-0x91B, which stay zero; the coding byte is ORed
  with the same value each time. So the sectors are built side by side.

This file imports nothing of the program under test.
"""

import json
import os

import numpy as np
import torch

from . import strmux

BANK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "swr_44100_37800.json")
MASTER_RATE, RATE, CHANNELS, BITS = 44100, 37800, 2, 4
SECTOR = 2336
PER_SECTOR = 2016               # samples a channel a sector
UNITS_A_SECTOR = strmux.XA_GROUPS * 4   # ADPCM units a channel a sector
EDC_AT = 0x91C
SUBHEADER = (0, 0, strmux.SUBMODE_AUDIO, 1)
BLOCK = 1 << 18                 # outputs of the resampler a step


def load_bank(path=BANK):
    with open(path) as f:
        return json.load(f)


def resampled_length(n, bank=None):
    """Output samples of ``n`` input samples: (n * L - D) // M."""
    b = bank or load_bank()
    return max(0, (n * b["L"] - b["D"]) // b["M"])


def resample(master, device, bank=None):
    """(n, ch) int16 at 44,100 Hz -> (m, ch) int16 tensor at 37,800 Hz on
    ``device``, m = ``resampled_length(n)``."""
    b = bank or load_bank()
    W, L, M = b["W"], b["L"], b["M"]
    x = torch.as_tensor(np.asarray(master), device=device).to(torch.int64)
    n, ch = x.shape
    m = resampled_length(n, b)
    starts = torch.tensor(b["starts"], dtype=torch.int64, device=device)
    taps = torch.tensor(b["taps"], dtype=torch.int64, device=device)
    K = taps.shape[1]
    out = torch.empty((m, ch), dtype=torch.int16, device=device)
    for lo in range(0, m, BLOCK):
        i = torch.arange(lo, min(lo + BLOCK, m), device=device)
        later = i >= W
        row = torch.where(later, W + (i - W) % L, i.clamp(max=W - 1))
        start = starts[row] + torch.where(later, M * ((i - W) // L), 0)
        idx = start[:, None] + torch.arange(K, device=device)
        win = torch.where((idx < n)[..., None],
                          x[idx.clamp(max=n - 1)], 0)   # (B, K, ch)
        acc = (win * taps[row][..., None]).sum(1)
        out[lo:lo + len(i)] = ((acc + 16384) >> 15).clamp(
            -32768, 32767).to(torch.int16)
    return out


def sector_lengths(samples):
    """Samples a channel of each sector of a stream of ``samples``."""
    full, rest = divmod(samples, PER_SECTOR)
    return [PER_SECTOR] * full + ([rest] if rest else [])


def edc(data):
    """cdrom.c's EDC of each row of an (S, n) uint8 tensor -> (S,) int64,
    the rows side by side, the bytes of a row one after another."""
    table = torch.tensor(strmux.EDC_TABLE, dtype=torch.int64,
                         device=data.device)
    rows = data.to(torch.int64)
    crc = torch.zeros(len(rows), dtype=torch.int64, device=data.device)
    for j in range(rows.shape[1]):
        crc = (crc >> 8) ^ table[(crc ^ rows[:, j]) & 0xFF]
    return crc


def check_config(cfg):
    want = {"format": "xa", "audio_frequency": RATE,
            "audio_channels": CHANNELS, "audio_bit_depth": BITS,
            "sector_bytes": SECTOR, "master_frequency": MASTER_RATE}
    wrong = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if wrong:
        raise ValueError(f"the reference writes psxavenc -t xa at its "
                         f"defaults only, not {wrong}")


def xa_file(cfg, master, device, rounds=None):
    """The bytes of the .xa file of an (n, 2) int16 master at 44,100 Hz
    under ``cfg``. ``rounds=1``: the control, ADPCM segments encoded from
    guessed start states and never repaired."""
    check_config(cfg)
    pcm = resample(master, device).cpu().numpy()
    lengths = sector_lengths(len(pcm))
    if not lengths:
        return b""
    payloads = torch.as_tensor(strmux.xa_payloads(pcm, lengths, device,
                                                  rounds=rounds),
                               device=device)
    sectors = torch.zeros((len(lengths), SECTOR), dtype=torch.uint8,
                          device=device)
    head = torch.tensor(SUBHEADER, dtype=torch.uint8, device=device)
    sectors[:, 0:4] = head
    sectors[:, 4:8] = head
    sectors[:, 8:8 + payloads.shape[1]] = payloads
    crc = edc(sectors[:, :EDC_AT])
    for k in range(4):
        sectors[:, EDC_AT + k] = ((crc >> (8 * k)) & 0xFF).to(torch.uint8)
    sectors[-1, 2] |= strmux.SUBMODE_EOF
    sectors[-1, 6] |= strmux.SUBMODE_EOF
    return sectors.cpu().numpy().tobytes()
