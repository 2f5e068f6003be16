"""The one generator of the benchmark's inputs, driven by a traffic file's
parameters and the run's seed.

Every seed gets the same sizes (frame count, clip lengths) and the same
kinds of content; the seed draws the content and the order of the clips.
Inputs are made in a few large calls on the run's device with a
``torch.Generator`` seeded from ``--seed`` and copied to the host once.
"""

import math
import struct

import numpy as np
import torch


def generator(seed, device, stream=0):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _u(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


GRAIN = 4.0         # film grain, luma levels (standard deviation)
CHUNK = 128         # frames made a call


def movie(seed, n_frames, width, height, device, scene_frames=150):
    """(n_frames, w*h*3/2) uint8 NV21 frames of synthetic motion video:
    scenes of ``scene_frames`` frames, each a drifting mix of gradients,
    plane waves and moving discs, with film grain. Returns a host array
    whose rows are consecutive, as a whole-file ingest lays frames out."""
    g = generator(seed, device, 1)
    n_scenes = -(-n_frames // scene_frames)
    waves, discs = 4, 6
    p = {
        "base": _u(g, (n_scenes, 3), 60, 190, device),
        "amp": _u(g, (n_scenes, waves), 10, 45, device),
        "kx": _u(g, (n_scenes, waves), -0.12, 0.12, device),
        "ky": _u(g, (n_scenes, waves), -0.12, 0.12, device),
        "w": _u(g, (n_scenes, waves), -0.3, 0.3, device),
        "ph": _u(g, (n_scenes, waves), 0, 2 * math.pi, device),
        "cx": _u(g, (n_scenes, discs), 0, width, device),
        "cy": _u(g, (n_scenes, discs), 0, height, device),
        "vx": _u(g, (n_scenes, discs), -4, 4, device),
        "vy": _u(g, (n_scenes, discs), -3, 3, device),
        "r": _u(g, (n_scenes, discs), 8, 48, device),
        "col": _u(g, (n_scenes, discs, 3), 20, 235, device),
    }
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    out = np.empty((n_frames, width * height * 3 // 2), np.uint8)
    for lo in range(0, n_frames, CHUNK):
        f = torch.arange(lo, min(lo + CHUNK, n_frames), device=device)
        s = f // scene_frames
        t = (f % scene_frames).to(torch.float32)[:, None, None]
        q = {k: v[s] for k, v in p.items()}

        def plane(x, y, t, ch):
            v = q["base"][:, ch, None, None].expand(len(f), *x.shape[-2:])
            v = v.clone()
            for i in range(waves):
                arg = (q["kx"][:, i, None, None] * x
                       + q["ky"][:, i, None, None] * y
                       + q["w"][:, i, None, None] * t
                       + q["ph"][:, i, None, None] + ch)
                v = v + q["amp"][:, i, None, None] * torch.sin(arg) * \
                    (0.4 if ch else 1.0)
            for i in range(discs):
                cx = q["cx"][:, i, None, None] + q["vx"][:, i, None, None] * t
                cy = q["cy"][:, i, None, None] + q["vy"][:, i, None, None] * t
                scale = 2.0 if ch else 1.0
                d2 = (x * scale - cx) ** 2 + (y * scale - cy) ** 2
                inside = d2 < q["r"][:, i, None, None] ** 2
                v = torch.where(inside, q["col"][:, i, ch, None, None], v)
            return v

        y = plane(xs, ys, t, 0)
        y = y + GRAIN * torch.randn(y.shape, generator=g, device=device)
        cy_, cx_ = ys[:height // 2], xs[:, :width // 2]
        cr = plane(cx_, cy_, t, 1)
        cb = plane(cx_, cy_, t, 2)
        vu = torch.stack([cr, cb], -1)
        frames = torch.cat([
            y.clamp(0, 255).round().to(torch.uint8).reshape(len(f), -1),
            vu.clamp(0, 255).round().to(torch.uint8).reshape(len(f), -1)],
            1)
        out[lo:lo + len(f)] = frames.cpu().numpy()
    return out


def clip_lengths(spec, rate):
    """Sample counts of the mix's clips, the same set for every seed:
    ``clips`` quantiles of a log-uniform or uniform law over
    [min_seconds, max_seconds]."""
    n = spec["clips"]
    lo, hi = spec["min_seconds"], spec["max_seconds"]
    q = (np.arange(n) + 0.5) / n
    if spec.get("spacing", "log") == "log":
        sec = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    else:
        sec = lo + q * (hi - lo)
    return [int(round(s * rate)) for s in sec]


def clips(seed, lengths, rate, device):
    """Mono int16 clips of the given lengths, in an order drawn from the
    seed. Every other length (by rank) is a tonal loop (a few partials
    with vibrato and a slow envelope), the rest effects (band-limited
    noise in bursts over a low tone), whatever the seed. Returns (list of
    host int16 arrays, the order: clip k has length
    lengths[order[k]])."""
    g = generator(seed, device, 2)
    n = len(lengths)
    order = torch.randperm(n, generator=g, device=device).cpu().numpy()
    sizes = np.asarray(lengths, np.int64)[order]
    total = int(sizes.sum())
    cid = torch.repeat_interleave(
        torch.arange(n, device=device),
        torch.as_tensor(sizes, device=device))
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                             device=device)
    t = (torch.arange(total, device=device) - starts[cid]).to(
        torch.float64) / rate
    partials = 5
    f0 = _u(g, (n,), 70, 660, device).double()
    amp = _u(g, (n, partials), 0.05, 0.3, device).double()
    vib = _u(g, (n,), 0, 0.01, device).double()
    ph = _u(g, (n, partials), 0, 2 * math.pi, device).double()
    env_f = _u(g, (n,), 0.1, 2.0, device).double()
    tonal = torch.zeros(total, dtype=torch.float64, device=device)
    for k in range(partials):
        fk = f0[cid] * (k + 1) * (1 + vib[cid] * torch.sin(2 * math.pi * 5
                                                           * t))
        tonal += amp[cid, k] * torch.sin(2 * math.pi * fk * t + ph[cid, k])
    tonal *= 0.6 + 0.4 * torch.sin(2 * math.pi * env_f[cid] * t)
    # Effects: white noise smoothed over a clip's window (a moving mean
    # by differences of the running sum), gated in bursts.
    noise = torch.randn(total, generator=g, device=device,
                        dtype=torch.float32).double()
    run = torch.cumsum(noise, 0)
    width = 1 + (_u(g, (n,), 0, 12, device)).long()
    idx = torch.arange(total, device=device)
    back = (idx - width[cid]).clamp(min=0)
    back = torch.maximum(back, starts[cid])
    smooth = (run - run[back]) / width[cid].double()
    burst = (torch.sin(2 * math.pi * env_f[cid] * 3 * t) > -0.2).double()
    effect = 0.5 * smooth * burst + 0.15 * torch.sin(2 * math.pi * f0[cid]
                                                      * 0.25 * t)
    kind = (torch.as_tensor(order, device=device)[cid] % 2 == 0)
    level = _u(g, (n,), 0.25, 0.9, device).double()
    x = torch.where(kind, tonal, effect) * level[cid] * 32767
    x = x.clamp(-32768, 32767).round().to(torch.int16).cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [x[bounds[k]:bounds[k + 1]] for k in range(n)], order


def write_avi(path, frames_nv21, width, height, fps, pcm, rate):
    """An AVI of raw I420 video (each NV21 frame's chroma split into its
    U and V planes) at ``fps`` frames/s and (n, channels) s16 PCM at
    ``rate``, each frame followed by its share of the audio."""
    n, ch = len(frames_nv21), pcm.shape[1]
    ysize = width * height
    fsize = ysize * 3 // 2
    per = -(-len(pcm) // n)
    chunks, index, offset = [], [], 4

    def add(tag, payload):
        nonlocal offset
        head = tag + struct.pack("<I", len(payload))
        pad = b"\x00" if len(payload) & 1 else b""
        chunks.append(head + payload + pad)
        index.append(tag + struct.pack("<III", 0x10, offset, len(payload)))
        offset += 8 + len(payload) + len(pad)

    for i, f in enumerate(frames_nv21):
        vu = f[ysize:].reshape(-1, 2)
        add(b"00db", f[:ysize].tobytes() + vu[:, 1].tobytes()
            + vu[:, 0].tobytes())
        seg = pcm[i * per:(i + 1) * per]
        if len(seg):
            add(b"01wb", np.ascontiguousarray(seg, "<i2").tobytes())

    def lst(four, payload):
        return b"LIST" + struct.pack("<I", len(four) + len(payload)) + \
            four + payload

    def chunk(tag, payload):
        return tag + struct.pack("<I", len(payload)) + payload

    avih = struct.pack("<14I", round(1_000_000 / fps), fsize * fps, 0, 0x10,
                       n, 0, 2, fsize, width, height, 0, 0, 0, 0)
    strh_v = b"vids" + b"I420" + struct.pack(
        "<IHHIIIIIIIi4H", 0, 0, 0, 0, 1, fps, 0, n, 0, 0xFFFFFFFF, 0, 0, 0,
        width, height)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 12, b"I420",
                         fsize, 0, 0, 0, 0)
    strh_a = b"auds" + b"\x00" * 4 + struct.pack(
        "<IHHIIIIIIIi4H", 0, 0, 0, 0, 1, rate, 0, len(pcm), 0, 0xFFFFFFFF,
        2 * ch, 0, 0, 0, 0)
    strf_a = struct.pack("<HHIIHH", 1, ch, rate, rate * 2 * ch, 2 * ch, 16)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v))
               + lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a)))
    movi_len = 4 + sum(len(c) for c in chunks)
    idx1 = b"".join(index)
    riff_len = 4 + len(hdrl) + 8 + movi_len + 8 + len(idx1)
    with open(path, "wb") as out:
        out.write(b"RIFF" + struct.pack("<I", riff_len) + b"AVI ")
        out.write(hdrl)
        out.write(b"LIST" + struct.pack("<I", movi_len) + b"movi")
        for c in chunks:
            out.write(c)
        out.write(chunk(b"idx1", idx1))
