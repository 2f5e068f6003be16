"""Chip smoke run of psxavenc_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, one or more lines each:

1. the card and toolchain;
2. the kernel build (nvcc, one process per source in
   psxavenc_tpu_torch/csrc, started together);
3. each BS kernel (K1-K4) against its plain PyTorch version at the video
   path's shapes (BS 320x240, 128 frames, 18,144-byte budgets), v2 and
   v3dc: exact equality; the kernel's device time (one wrapper call
   captured as a CUDA graph and replayed back to back, so without the
   host's work), one wrapper call's and the plain version's times (CUDA
   events, median);
4. the video path: BsFrameEncoder on the card over 256 frames for v2, v3
   and v3dc, each codec's bytes equal to its committed digest, K1-K4
   launched;
5. the video CLI (-t sbs, -t strv) as subprocesses on a synthetic AVI,
   equal to the digests;
6. frames/s: device, end to end, and the plain path on the card, with a
   torch.profiler breakdown of the device step;
7. K5 against its plain version on 4,096 streams x 64 units for
   (filter_count, shift_range) = (5, 12), (4, 12) and (4, 8), timed as
   in phase 3;
8. the batch API at full width: api.spu_encode_batch on 4,096 x 1,000
   SPU units, Msamples/s on the device, the kernel's share of its bound,
   peak device memory;
9. the audio and A/V path: the CLI (-t xa, xacd, spu, vag, vagi, and the
   flagship -t strcd / -t str: 320x240 15 fps BS v2 with 37,800 Hz stereo
   XA) run in this process on the card, every output equal to its
   digest, K5 (and K1, K3, K4 for str/strcd) launched; seconds per file
   and, from torch.profiler, K5's device time on the 60 s track;
10. the symbols API and the per-block-stream packers at the video path's
   width: K6, K7 (both coefficient forms), K9 and K10 against their plain
   versions on phase 4's first 128 frames (video+noise, one frame's
   budget cut to 200 bytes: unfittable), timed as in phase 3; every
   packer of
   api.bs_encode_frames_packed with the kernel sweep and without on
   phase 4's 256 frames, each equal to fused_mxu; api.bs_encode_frames on
   128 frames, flat-packed equal to fused_mxu and its first frames equal
   to the JAX package's symbols digest; K6, K7, K8 (fused_gather), K9
   and K10 launched;
11. K8 and the multi-file entry points: K8 against its plain version and
   against K4 on K3's placement prep for phase 10's 128 frames (the
   unfittable frame included), timed as in phase 3; the batch runner
   (psxavenc_tpu_torch.batch) on a job list of real sizes (six 2-4 s
   44,100 Hz vag files, a 10 s stereo 37,800 Hz xa, a 3-channel spui, the
   40-frame 320x240 strv and sbs, the flagship strcd), grouped and serial,
   every file equal between the two runs and to its digest, K1, K3, K4
   and K5 launched; its streaming tier's chunk batcher on three vag files
   and the xa with small chunks, equal to the digests, with chunk rounds
   that shared a device call; libpsxav's xa_encode_simple on the 10 s
   track and spu_encode_simple with a loop point, equal to their
   digests.

The digests (psxavenc_tpu_torch/data/smoke_digests.json) are the JAX
package's outputs for the same inputs; tests/test_torch_smoke_refs.py
recomputes them on the CPU from the recipes below. The ptxas report and
the profiler tables are written under ``--out`` (default ``smoke_out/``).

Any failure ends the run with a nonzero exit and no result; so does a
machine without a CUDA device. The last three lines are the kernel table
as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(ROOT, "psxavenc_tpu_torch", "data",
                       "smoke_digests.json")

W, H = 320, 240
B = 128
BUDGET = 18144                       # 9 sectors x 2,016 bytes
CAP_WORDS = (BUDGET - 8 + 1) // 2
MAIN_FRAMES = 256
CLI_FRAMES = 40
FLAGSHIP_FRAMES = 60                 # 4 s at 15 fps
ADPCM_STREAMS = 4096                 # the batch shape of bench.py:149
ADPCM_UNITS = 1000
ADPCM_CHECK_UNITS = 64
ADPCM_VARIANTS = ((5, 12), (4, 12), (4, 8))
SYMBOLS_FRAMES = 8                   # frames of the symbols_v2 digest
UNFIT_FRAME, UNFIT_BUDGET = 5, 200   # phase 10's unfittable frame
PACKERS = ("fused_mxu", "fused", "fused_pallas", "fused_gather", "blocks",
           "blocks_pallas", "flat")

# (wrapper name, source, TPU kernel it replaces)
KERNELS = [
    ("select_scale_pix", "psxavenc_tpu_torch/csrc/bs_select.cu",
     "psxavenc_tpu/ops/bs_pallas.py:412"),
    ("dc_stage", "psxavenc_tpu_torch/csrc/bs_dc.cu",
     "psxavenc_tpu/ops/bs_pallas.py:542"),
    ("emit_prep", "psxavenc_tpu_torch/csrc/bs_emit.cu",
     "psxavenc_tpu/ops/bs_pallas.py:891"),
    ("place_vals", "psxavenc_tpu_torch/csrc/bitpack_place.cu",
     "psxavenc_tpu/ops/bitpack_pallas.py:315"),
    ("place_vals_gather", "psxavenc_tpu_torch/csrc/bitpack_gather.cu",
     "psxavenc_tpu/ops/bitpack_pallas.py:400"),
    ("adpcm_encode_units", "psxavenc_tpu_torch/csrc/adpcm_units.cu",
     "psxavenc_tpu/ops/adpcm_pallas.py:194"),
    ("select_scale", "psxavenc_tpu_torch/csrc/bs_select.cu",
     "psxavenc_tpu/ops/bs_pallas.py:328"),
    ("emit_pack", "psxavenc_tpu_torch/csrc/bs_emit.cu",
     "psxavenc_tpu/ops/bs_pallas.py:711"),
    ("place_streams", "psxavenc_tpu_torch/csrc/bitpack_streams.cu",
     "psxavenc_tpu/ops/bitpack_pallas.py:453"),
    ("pack_block_streams", "psxavenc_tpu_torch/csrc/bitpack_streams.cu",
     "psxavenc_tpu/ops/bitpack_pallas.py:64"),
]

# ---------------------------------------------------------------- bounds
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over HBM3's
# 3.35 TB/s and its integer operations over the SMs' int32 rate. NVIDIA's
# data sheet gives no int32 rate outside the tensor cores; the Hopper
# white paper gives 64 INT32 lanes per SM, so 132 SMs x 64 x the 1.98 GHz
# boost clock. Operations per element, counted from the kernels' code:
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_FDCT_BLOCK = 900      # K1: two 8x8 islow passes + descale + zigzag
OPS_SCALE_EVAL = 20       # K1: quantize, run, closed-form bits, per coef
OPS_DC_BLOCK = 12         # K2: difference, wrap, size, code
OPS_EMIT_COEF = 24        # K3: quantize, run, code, window placement
OPS_PLACE_WORD = 4        # K4, K8, K9: test, offset, bound check, OR
OPS_FUNNEL_WORD = 6       # K9: shift, carry shift, mask, OR, LE pairing
OPS_PACK_SYMBOL = 24      # K10: length mask, window index and shifts,
                          #     two-window OR, per symbol slot
OPS_ADPCM_STEP = 20       # K5: predict, quantize, clip, decode, error,
                          #     pack, per candidate and sample
OPS_ADPCM_RESID = 8       # K5: residual and extrema, per filter, sample


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops):
    """(bound ms, what bounds it)."""
    ms_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / INT32_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                            "operations")


def adpcm_ops(n_units, filter_count):
    return n_units * 28 * (3 * filter_count * OPS_ADPCM_STEP
                           + filter_count * OPS_ADPCM_RESID)


# ------------------------------------------------- inputs, from seeds
# Shared with tests/test_torch_smoke_refs.py, which computes the digests
# of these inputs with the JAX package. ``synth`` is
# psxavenc_tpu_torch.utils.synth (or, in that test, the JAX package's).
# Audio is written at the output's own rate and channel count, so no
# resampler runs.

# (digest key, CLI arguments, input file)
VIDEO_CLI_CASES = [
    ("cli_sbs_v3dc", ["-t", "sbs", "-v", "v3dc"], "in.avi"),
    ("cli_strv", ["-t", "strv"], "in.avi"),
]
AV_CLI_CASES = [
    ("xa_37800_stereo_4bit", ["-t", "xa", "-f", "37800", "-c", "2",
                              "-b", "4"], "track.wav"),
    ("xacd_18900_mono_8bit", ["-t", "xacd", "-f", "18900", "-c", "1",
                              "-b", "8"], "mono18900.wav"),
    ("spu", ["-t", "spu", "-f", "44100"], "mono44100.wav"),
    ("vag_loop", ["-t", "vag", "-f", "44100"], "loop44100.wav"),
    ("vagi_stereo", ["-t", "vagi", "-f", "44100", "-c", "2"],
     "stereo44100.wav"),
    ("strcd_flagship", ["-t", "strcd", "-x", "2", "-v", "v2", "-f",
                        "37800", "-c", "2"], "flagship.avi"),
    ("str_flagship", ["-t", "str", "-x", "2", "-v", "v2", "-f", "37800",
                      "-c", "2"], "flagship.avi"),
]
PHASE4_CODECS = ((0, "v2"), (1, "v3"), (2, "v3dc"))
# Phase 11's batch job list: new audio inputs with their own digests, and
# the video and flagship CLI cases, whose digests the batch outputs must
# equal too.
BATCH_VAG_SECONDS = (2.0, 2.4, 2.8, 3.2, 3.6, 4.0)
BATCH_AUDIO_CASES = [
    (f"batch_vag{k}", ["-t", "vag", "-f", "44100"], f"vag{k}.wav")
    for k in range(len(BATCH_VAG_SECONDS))] + [
    ("batch_xa_10s", ["-t", "xa", "-f", "37800", "-c", "2", "-b", "4"],
     "xa10s.wav"),
    ("batch_spui_3ch", ["-t", "spui", "-f", "44100", "-c", "3"],
     "spui3.wav"),
]
BATCH_CASES = BATCH_AUDIO_CASES + VIDEO_CLI_CASES + [
    c for c in AV_CLI_CASES if c[0] == "strcd_flagship"]
STREAM_CASES = BATCH_AUDIO_CASES[:3] + [
    c for c in BATCH_AUDIO_CASES if c[0] == "batch_xa_10s"]
STREAM_SPU_CHUNK_BLOCKS = 1024       # 3-5 chunk rounds per vag file
STREAM_XA_CHUNK_SECTORS = 32         # 6 chunk rounds for the xa
LIBPSXAV_KEYS = ("libpsxav_xa_simple", "libpsxav_spu_simple_loop")
LIBPSXAV_LOOP_START = 30000


def out_name(key):
    """The output file name of a CLI case (.vag headers embed it)."""
    return f"{key}.out"


def write_inputs(synth, d):
    """Every input file of the CLI phases, written into directory d."""
    j = os.path.join
    synth.write_avi_sized(j(d, "in.avi"), W, H,
                          synth.rand_frames(W, H, CLI_FRAMES, seed=12), 15)
    # As tests/test_golden_bs.py:137-147 builds the flagship input.
    n_audio = int(37800 * (FLAGSHIP_FRAMES / 15) * 1.4) + 4000
    synth.write_avi_sized(
        j(d, "flagship.avi"), W, H,
        synth.rand_frames(W, H, FLAGSHIP_FRAMES, seed=99), 15,
        audio=synth.rand_pcm(n_audio, channels=2, seed=98),
        audio_rate=37800)
    synth.write_wav(j(d, "track.wav"),
                    synth.rand_pcm(37800 * 60, channels=2, seed=21), 37800,
                    channels=2)
    synth.write_wav(j(d, "mono18900.wav"),
                    synth.rand_pcm(18900 * 3 // 2, seed=22), 18900)
    synth.write_wav(j(d, "mono44100.wav"), synth.rand_pcm(88200, seed=23),
                    44100)
    synth.write_wav(j(d, "loop44100.wav"), synth.rand_pcm(88200, seed=24),
                    44100, loop_start=30000)
    synth.write_wav(j(d, "stereo44100.wav"),
                    synth.rand_pcm(88200, channels=2, seed=25), 44100,
                    channels=2)
    for k, secs in enumerate(BATCH_VAG_SECONDS):
        synth.write_wav(j(d, f"vag{k}.wav"), batch_vag_pcm(synth, k), 44100)
    synth.write_wav(j(d, "xa10s.wav"), xa10s_pcm(synth), 37800, channels=2)
    synth.write_wav(j(d, "spui3.wav"),
                    synth.rand_pcm(88200, channels=3, seed=37), 44100,
                    channels=3)


def batch_vag_pcm(synth, k):
    return synth.rand_pcm(int(44100 * BATCH_VAG_SECONDS[k]), seed=30 + k)


def xa10s_pcm(synth):
    """The 10 s stereo 37,800 Hz track: (378000, 2) int16."""
    return synth.rand_pcm(378000, channels=2, seed=36)


def libpsxav_outputs(lp, synth, **kw):
    """The libpsxav outputs held to digests: xa_encode_simple on the 10 s
    track, spu_encode_simple on the first vag file's PCM with a loop
    point. ``lp`` is a libpsxav module; ``kw`` goes to both calls."""
    pcm = xa10s_pcm(synth)
    xa = lp.xa_encode_simple(lp.XaSettings(stereo=True, bits_per_sample=4,
                                           frequency=37800),
                             pcm.reshape(-1), len(pcm), **kw)
    spu = lp.spu_encode_simple(batch_vag_pcm(synth, 0), LIBPSXAV_LOOP_START,
                               **kw)
    return dict(zip(LIBPSXAV_KEYS, (xa, spu)))


def nv21(np, planes):
    y, cb, cr = planes
    c = np.stack([cr.reshape(H // 2, W // 2), cb.reshape(H // 2, W // 2)],
                 axis=-1).reshape(-1)
    return np.concatenate([y, c]).astype(np.uint8)


def smoke_frames(np, synth, n, seed, noise_every=8):
    """n NV21 frames: synthetic video with every ``noise_every``-th frame
    noise (0: none). Noise frames take the overflow path at 18,144
    bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, planes in enumerate(synth.rand_frames(W, H, n, seed=seed)):
        if noise_every and i % noise_every == noise_every - 1:
            out.append(rng.integers(0, 256, W * H * 3 // 2).astype(np.uint8))
        else:
            out.append(nv21(np, planes))
    return np.stack(out)


def phase4_frames(np, synth):
    return smoke_frames(np, synth, MAIN_FRAMES, seed=9)


def adpcm_units(np, synth, streams, units, seed=41):
    """(streams, units, 28) int32 SPU units from synth.rand_pcm, limits
    with a partial unit, a limit of 0, a negative limit and a masked tail,
    and nonzero prev states."""
    groups = []
    for g in range(0, streams, 512):
        n = min(512, streams - g)
        pcm = synth.rand_pcm(units * 28, channels=n, seed=seed + g)
        groups.append(pcm.reshape(units * 28, n).T)
    pcm = np.ascontiguousarray(np.concatenate(groups), dtype=np.int32)
    lim = np.full((streams, units), 28, np.int32)
    lim[0, 3] = 17
    lim[1, 5] = 0
    lim[2, 7] = -3
    lim[3, units - 10:] = 0
    lim[4, 1] = 1
    rng = np.random.default_rng(seed)
    p1 = rng.integers(-0x8000, 0x8000, streams).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, streams).astype(np.int32)
    return pcm.reshape(streams, units, 28), lim, p1, p2


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def symbols_frames(np, synth):
    return phase4_frames(np, synth)[:SYMBOLS_FRAMES]


def symbols_digest(np, out):
    """sha256 of a bs_encode_frames dict of numpy arrays: scale, nz_count
    and total_bits as int32, codes as uint32, bits as int32."""
    parts = [np.asarray(out[k]).astype("<i4")
             for k in ("scale", "nz_count", "total_bits")]
    parts += [np.asarray(out["codes"]).astype("<u4"),
              np.asarray(out["bits"]).astype("<i4")]
    return sha256(b"".join(p.tobytes() for p in parts))


# ----------------------------------------------------------------- phases

def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, reps=10):
    """Median milliseconds of fn on the card (CUDA events), after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, reps=20):
    """Mean device milliseconds of fn's work: one call captured as a CUDA
    graph, replayed ``reps`` times back to back between CUDA events, so
    the host's work per call (argument checks, allocation, the launch
    itself) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(torch, got, want, name):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    return err


def compare(torch, results, tag, name, label, kernel_fn, plain_fn, inputs,
            ops_fn, card, library_fn=None):
    """The kernel == its plain version, exactly; prints and keeps (the
    first time per name) the wrapper's device time (``graph_ms``), the
    wrapper call's and the plain version's times (CUDA events, median)
    and the bound computed from ``inputs``, the outputs and
    ``ops_fn(out)``. ``library_fn`` is one PyTorch call computing the same
    function, timed as the wrapper is."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want, name)
    ms = graph_ms(torch, kernel_fn)
    call_ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn, reps=3)
    library_ms = graph_ms(torch, library_fn) if library_fn else None
    outs = got if isinstance(got, tuple) else (got,)
    bound_ms, bound_by = bound(nbytes(*inputs, *outs), ops_fn(got))
    lib = f", one PyTorch call {library_ms:.4f} ms" if library_fn else ""
    say(f"[{tag}] {name} {label}: max |kernel - plain| = {err}; kernel "
        f"{ms:.4f} ms on the device (graph replay; one wrapper call "
        f"{call_ms:.4f} ms with its host work), plain {plain_ms:.4f} ms{lib}, bound "
        f"{bound_ms:.4f} ms ({bound_by}) (B={B}, {W}x{H}) on {card}")
    if err:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    results.setdefault(name, {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": library_ms})
    return got


def select_ops(torch, nb, fdct):
    """The operations of K1 (with ``fdct``) and K6 on their output: the
    data needs the exact total at the chosen scale and at the scale below
    it (one evaluation for scale 1 and for unfittable frames)."""
    def ops(out):
        evals = torch.where((out[0] > 1) & (out[0] <= 63), 2, 1)
        return nb * (B * OPS_FDCT_BLOCK * fdct
                     + 63 * OPS_SCALE_EVAL * int(evals.sum()))
    return ops


def check_kernels(torch, np, synth, card):
    """Phase 3: each BS kernel == its plain version; returns the timings
    and bounds of the first check of each."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(smoke_frames(np, synth, B, seed=5)).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    pix = bs_ops.rearrange_nv21_rows(frames, W, H)
    nb = pix.shape[2]
    dc_q = bs_ops.dc_quant_from_pixrows(pix)
    results = {}

    def check(*args, **kw):
        return compare(torch, results, 3, *args, card, **kw)

    for codec, label in ((bs_ops.BS_V2, "v2"), (bs_ops.BS_V3DC, "v3dc")):
        if codec == bs_ops.BS_V2:
            dc_bits, dc_code = bs_ops._dc_stage(dc_q, codec)
        else:
            dc_bits, dc_code = check(
                "dc_stage", label, lambda: bs_cuda.dc_stage(dc_q, codec),
                lambda: bs_cuda.dc_stage_plain(dc_q, codec), (dc_q,),
                lambda out: B * nb * OPS_DC_BLOCK)
        thr = bs_ops.ac_threshold(
            budgets, dc_bits.sum(dim=1, dtype=torch.int32), nb)
        scale, _, _, coefs = check(
            "select_scale_pix", label,
            lambda: bs_cuda.select_scale_pix(pix, thr),
            lambda: bs_cuda.select_scale_pix_plain(pix, thr), (pix, thr),
            select_ops(torch, nb, 1))
        sidx = torch.where(scale <= 63, scale, 1)
        eof = 0x1FF if codec == bs_ops.BS_V2 else 0x3FF
        vals32, e0, _, _ = check(
            "emit_prep", label,
            lambda: bs_cuda.emit_prep(coefs, sidx, dc_code, dc_bits, eof=eof),
            lambda: bs_cuda.emit_prep_plain(coefs, sidx, dc_code, dc_bits,
                                            eof=eof),
            (coefs, sidx, dc_code, dc_bits),
            lambda out: B * nb * 63 * OPS_EMIT_COEF)
        lib_fn, lib_words = scatter_add_call(torch, vals32, e0)
        check("place_vals", label,
              lambda: bitpack_cuda.place_vals(vals32, e0,
                                              capacity_words=CAP_WORDS),
              lambda: bitpack_cuda.place_vals_plain(
                  vals32, e0, capacity_words=CAP_WORDS), (vals32, e0),
              lambda out: vals32.numel() * OPS_PLACE_WORD,
              library_fn=lib_fn)
        if not torch.equal(lib_words, bitpack_cuda.place_vals(
                vals32, e0, capacity_words=CAP_WORDS)):
            raise AssertionError("one scatter_add_ on prepared indices "
                                 "differs from K4")
    return results


def scatter_add_call(torch, vals32, e0):
    """One scatter_add_ computes K4's, K8's and K9's placement from the
    placed u32 words (int32 bit patterns) and their prepared, clipped
    indices (a spare column takes the dropped words): the words are
    bit-disjoint, so add == or. Returns (the call, for timing; the (B,
    cap32) words of one call on a zeroed output)."""
    cap32 = (CAP_WORDS + 1) // 2
    b = vals32.shape[0]
    vals = vals32.to(torch.int32).reshape(b, -1)
    idx = (e0.to(torch.int64)[..., None]
           + torch.arange(9, device=e0.device)).clamp(max=cap32).reshape(
        b, -1)
    out = torch.zeros((b, cap32 + 1), dtype=torch.int32, device=e0.device)
    out.scatter_add_(1, idx, vals)
    words = out[:, :cap32].clone()
    return (lambda: out.scatter_add_(1, idx, vals)), words


def reset(counters):
    for counts in counters:
        for k in counts:
            counts[k] = 0


def main_path(torch, np, synth, digests):
    """Phase 4: the video path on the card == the digests; returns the
    launch counts of this phase."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    frames = phase4_frames(np, synth)
    budgets = [BUDGET] * MAIN_FRAMES
    reset((bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, api.COUNTERS))
    for codec, label in PHASE4_CODECS:
        enc = BsFrameEncoder(codec, W, H, "cuda")
        got = enc.encode_frames(list(frames), budgets)
        digest = sha256(b"".join(buf.tobytes() for buf, _ in got))
        if digest != digests[f"phase4_{label}"]:
            raise AssertionError(f"{label}: {MAIN_FRAMES} frames differ "
                                 "from the JAX package's digest")
        say(f"[4] {label}: {MAIN_FRAMES} frames {W}x{H} equal the JAX "
            f"package's digest; mean quant scale "
            f"{enc.quant_scale_sum / MAIN_FRAMES:.2f}")
    launches = dict(bs_cuda.LAUNCHES, **bitpack_cuda.LAUNCHES)
    say(f"[4] launches in the video path: {launches}; frames on the "
        f"overflow path: {api.COUNTERS['overflow_frames']} of "
        f"{3 * MAIN_FRAMES}")
    for name in ("select_scale_pix", "dc_stage", "emit_prep", "place_vals"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "video path")
    return launches


def file_digest(path):
    with open(path, "rb") as f:
        return sha256(f.read())


def cli_phase(digests, tmp):
    """Phase 5: the port's video CLI as a user runs it."""

    def run(argv, out, platform):
        env = dict(os.environ, PSXAVENC_PLATFORM=platform)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "psxavenc_tpu_torch.cli", "-q", *argv,
             os.path.join(tmp, "in.avi"), out],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"cli {argv} ({platform}) exited "
                                 f"{proc.returncode}: {proc.stderr}")
        return time.time() - t0

    for key, argv, _ in VIDEO_CLI_CASES:
        for platform in (("cuda", "cpu") if key == "cli_strv"
                         else ("cuda",)):
            out = os.path.join(tmp, platform, out_name(key))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            secs = run(argv, out, platform)
            if file_digest(out) != digests[key]:
                raise AssertionError(f"cli {' '.join(argv)} on {platform} "
                                     "differs from the JAX package")
            say(f"[5] cli {' '.join(argv)} on {platform}: {CLI_FRAMES} "
                f"frames equal the JAX package's digest ({secs:.1f} s incl. "
                "start-up)")


def profile_step(torch, step, label, step_ms, card, out_dir, reps=5):
    """Device time by kernel over ``reps`` steps (torch.profiler), against
    the step's CUDA-event time; the full table goes to
    <out_dir>/profile_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=40))
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000 / reps
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    say(f"[6] profile {label}: kernels busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step); "
        "top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1000 / reps:.3f} ms"
            for e in top) + f" (on {card})")


def throughput(torch, np, synth, card, out_dir):
    """Phase 6: BS v2 320x240 frames/s at B=128, on synthetic video and
    on the same with every eighth frame noise (overflow path)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    dev = torch.device("cuda", 0)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    for label, noise_every in (("video", 0), ("video+noise", 8)):
        host = smoke_frames(np, synth, B, seed=14, noise_every=noise_every)
        frames = torch.from_numpy(host).to(dev)

        def step(use_kernels=True):
            return api.bs_encode_frames_packed(
                frames, budgets, codec=0, width=W, height=H,
                capacity_words=CAP_WORDS, use_kernels=use_kernels)

        before = api.COUNTERS["overflow_frames"]
        step()
        overflow = api.COUNTERS["overflow_frames"] - before
        ms = time_ms(torch, step, reps=20)
        say(f"[6] {label} device: {B / ms * 1000:.1f} frames/s ({ms:.4f} ms "
            f"per {B}-frame batch, kernels + glue, no H2D; {overflow} of "
            f"{B} frames on the overflow path) on {card}")
        profile_step(torch, step, label.replace("+", "_"), ms, card, out_dir)
        plain_ms = time_ms(torch, lambda: step(False), reps=3)
        say(f"[6] {label} plain path on the card: "
            f"{B / plain_ms * 1000:.1f} frames/s ({plain_ms:.4f} ms per "
            f"batch) on {card}")

        enc = BsFrameEncoder(0, W, H, dev)
        frame_list = list(np.concatenate([host] * 8))
        enc.encode_frames(frame_list[:B], [BUDGET] * B)         # warm-up
        t0 = time.perf_counter()
        enc.encode_frames(frame_list, [BUDGET] * len(frame_list))
        dt = time.perf_counter() - t0
        say(f"[6] {label} end to end: {len(frame_list) / dt:.1f} frames/s "
            f"({len(frame_list)} frames, H2D + device + D2H + headers) on "
            f"{card}")


def adpcm_kernel(torch, np, synth, card):
    """Phase 7: K5 == its plain version for the three variants at 4,096
    streams x 64 units. Returns (the inputs on the card, the (5, 12)
    kernel outputs, the (5, 12) row of the kernel table)."""
    from psxavenc_tpu_torch.ops import adpcm_cuda

    dev = torch.device("cuda", 0)
    units, lim, p1, p2 = adpcm_units(np, synth, ADPCM_STREAMS, ADPCM_UNITS)
    full = [torch.from_numpy(a).to(dev) for a in (units, lim, p1, p2)]
    head = [full[0][:, :ADPCM_CHECK_UNITS].contiguous(),
            full[1][:, :ADPCM_CHECK_UNITS].contiguous(), full[2], full[3]]
    row = ref = None
    for fc, sr in ADPCM_VARIANTS:
        def kernel_fn():
            return adpcm_cuda.encode_units(*head, filter_count=fc,
                                           shift_range=sr)

        def plain_fn():
            return adpcm_cuda.encode_units_plain(*head, filter_count=fc,
                                                 shift_range=sr)

        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want, "adpcm_encode_units")
        ms = graph_ms(torch, kernel_fn)
        call_ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn, reps=1)
        n_units = ADPCM_STREAMS * ADPCM_CHECK_UNITS
        bound_ms, bound_by = bound(nbytes(*head, *got), adpcm_ops(n_units, fc))
        say(f"[7] adpcm_encode_units ({fc}, {sr}): headers, words, s1, s2 "
            f"max |kernel - plain| = {err}; kernel {ms:.4f} ms on the device "
            f"(graph replay; one wrapper call {call_ms:.4f} ms with its host "
            f"work), "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"({ADPCM_STREAMS} streams x {ADPCM_CHECK_UNITS} units) on {card}")
        if err:
            raise AssertionError(f"K5 ({fc}, {sr}) disagrees with its plain "
                                 "version")
        if row is None:
            ref = got
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    return full, ref, row


def adpcm_batch(torch, full, ref, card):
    """Phase 8: api.spu_encode_batch at 4,096 x 1,000 units."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import adpcm_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    h, values, s1, s2 = api.spu_encode_batch(*full)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n = ADPCM_CHECK_UNITS
    want = (ref[0], adpcm_cuda.unpack_words(ref[1], 12), ref[2], ref[3])
    err = max_abs_err(torch, (h[:, :n], values[:, :n], s1[:, :n],
                              s2[:, :n]), want, "spu_encode_batch")
    if err:
        raise AssertionError("spu_encode_batch's first units differ from "
                             "the checked kernel run")
    for t in (h, values, s1, s2):
        if t.shape[:2] != (ADPCM_STREAMS, ADPCM_UNITS):
            raise AssertionError("spu_encode_batch: wrong output shape")
    ms = time_ms(torch, lambda: adpcm_cuda.encode_units(
        *full, filter_count=5, shift_range=12), reps=5)
    out = adpcm_cuda.encode_units(*full, filter_count=5, shift_range=12)
    n_units = ADPCM_STREAMS * ADPCM_UNITS
    bound_ms, bound_by = bound(nbytes(*full, *out), adpcm_ops(n_units, 5))
    api_ms = time_ms(torch, lambda: api.spu_encode_batch(*full), reps=3)
    say(f"[8] spu_encode_batch {ADPCM_STREAMS} x {ADPCM_UNITS} units "
        f"({n_units * 28 / 1e6:.1f} M samples, "
        f"{full[0].numel() * 4 / 1e6:.0f} MB of int32 units on the card): "
        f"first {n} units equal the checked kernel run; K5 {ms:.3f} ms = "
        f"{n_units * 28 / ms / 1e3:.1f} Msamples/s on the device, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of the "
        f"bound; whole API call {api_ms:.3f} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; on {card}")


def av_path(torch, digests, tmp, card, out_dir):
    """Phase 9: the audio formats and str/strcd through the CLI in this
    process on the card; returns the launch counts of this phase."""
    from torch.profiler import ProfilerActivity, profile

    from psxavenc_tpu_torch import cli
    from psxavenc_tpu_torch.ops import adpcm_cuda, bitpack_cuda, bs_cuda

    os.environ["PSXAVENC_PLATFORM"] = "cuda"
    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, adpcm_cuda.LAUNCHES)
    total = {}
    reset(counters)
    for key, argv, src in AV_CLI_CASES:
        before = {k: v for c in counters for k, v in c.items()}
        out = os.path.join(tmp, "cuda", out_name(key))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        track = key == "xa_37800_stereo_4bit"
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if track else None
        t0 = time.perf_counter()
        if prof:
            prof.start()
        rc = cli.main(["-q", *argv, os.path.join(tmp, src), out])
        torch.cuda.synchronize()
        if prof:
            prof.stop()
        secs = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
        if file_digest(out) != digests[key]:
            raise AssertionError(f"cli {' '.join(argv)} differs from the JAX "
                                 "package")
        ran = {k: v - before[k] for c in counters for k, v in c.items()
               if v - before[k]}
        extra = ""
        if prof:
            rows = prof.key_averages()
            with open(os.path.join(out_dir, "profile_xa_track.txt"),
                      "w") as f:
                f.write(rows.table(sort_by="self_device_time_total",
                                   row_limit=30))
            k5 = sum(e.self_device_time_total for e in rows
                     if "adpcm_units_kernel" in e.key) / 1000
            extra = f"; K5 device time {k5:.1f} ms (profiler)"
        say(f"[9] cli {' '.join(argv)} {src}: equals the JAX package's "
            f"digest; {secs:.2f} s in process{extra}; launches {ran} on "
            f"{card}")
        if not ran.get("adpcm_encode_units"):
            raise AssertionError(f"cli {' '.join(argv)} never launched K5")
        if key.startswith("str") and not all(
                ran.get(k) for k in ("select_scale_pix", "emit_prep",
                                     "place_vals")):
            raise AssertionError(f"cli {' '.join(argv)} did not launch "
                                 "K1, K3 and K4")
    for c in counters:
        total.update(c)
    return total


def block_stream_kernels(torch, np, synth, card):
    """Phase 10, kernels: K6, K7 (both coefficient forms), K9 and K10 ==
    their plain versions on phase 4's first 128 frames, one of them
    unfittable. Returns the rows of the kernel table."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(phase4_frames(np, synth)[:B]).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    budgets[UNFIT_FRAME] = UNFIT_BUDGET
    sel = bs_ops.encode_frames_symbols(api._frames_to_coefs(frames, W, H),
                                       budgets, codec=0, kernel_sweep=False,
                                       emit=False)
    c, dc_bits, dc_code = sel["c"], sel["dc_bits"], sel["dc_code"]
    nb = c.shape[2]
    thr = bs_ops.ac_threshold(budgets, dc_bits.sum(dim=1, dtype=torch.int32),
                              nb)
    results = {}

    def check(*args, **kw):
        return compare(torch, results, 10, *args, card, **kw)

    scale, _, _ = check(
        "select_scale", "(63, NB) int32",
        lambda: bs_cuda.select_scale(c, thr),
        lambda: bs_cuda.select_scale_plain(c, thr), (c, thr),
        select_ops(torch, nb, 0))
    if int(scale[UNFIT_FRAME]) != 64 or not (scale[:UNFIT_FRAME] <= 63).all():
        raise AssertionError("phase 10: the unfittable frame was not found")
    sidx = torch.where(scale <= 63, scale, 1)
    emit_ops = B * nb * 63 * OPS_EMIT_COEF
    emit_args = (sidx, dc_code, dc_bits)
    streams, block_bits = check(
        "emit_pack", "(63, NB) int32",
        lambda: bs_cuda.emit_pack(c, *emit_args),
        lambda: bs_cuda.emit_pack_plain(c, *emit_args), (c, *emit_args),
        lambda out: emit_ops)
    c64 = bs_cuda.select_scale_pix(bs_ops.rearrange_nv21_rows(frames, W, H),
                                   thr)[3]
    check("emit_pack", "(64, nb_pad) int16",
          lambda: bs_cuda.emit_pack(c64, *emit_args),
          lambda: bs_cuda.emit_pack_plain(c64, *emit_args),
          (c64, *emit_args), lambda out: emit_ops)

    streams, bb = bitpack_ops.with_eof_block(streams, block_bits, 0x1FF)
    goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
    total = goff[:, -1] + bb[:, -1]
    nbe = nb + 1
    vals32, e0 = bitpack_ops.streams_to_u32(streams, goff)
    lib_fn, lib_words = scatter_add_call(
        torch, bitpack_ops.u32_to_i32(vals32), e0)
    same = torch.equal(
        bitpack_ops.u16_values(lib_words, CAP_WORDS),
        bitpack_cuda.place_streams(streams, goff, total,
                                   capacity_words=CAP_WORDS))
    say(f"[10] place_streams: one scatter_add_ on the prepared (words, "
        f"indices) gives K9's words: {same}")
    check("place_streams", "", lambda: bitpack_cuda.place_streams(
              streams, goff, total, capacity_words=CAP_WORDS),
          lambda: bitpack_cuda.place_streams_plain(
              streams, goff, total, capacity_words=CAP_WORDS),
          (streams, goff),
          lambda out: B * nbe * (16 * OPS_FUNNEL_WORD + 9 * OPS_PLACE_WORD),
          library_fn=lib_fn if same else None)

    codes, bits = bs_ops.emit_symbols_at(c, sidx - 1, dc_bits, dc_code)
    codes, bits = api._with_eof_symbols(codes, bits, 0x1FF)
    codes = bitpack_ops.u32_to_i32(codes)
    bits = bits.to(torch.int32)
    check("pack_block_streams", "(B, NB + 1, 65)",
          lambda: bitpack_cuda.pack_block_streams(codes, bits),
          lambda: bitpack_cuda.pack_block_streams_plain(codes, bits),
          (codes, bits), lambda out: codes.numel() * OPS_PACK_SYMBOL)
    return results, (c64, sidx, dc_code, dc_bits)


def words_equal(torch, got, ref, total_bits):
    """The words of two packers up to each frame's bits."""
    n = (total_bits.to(torch.int64) + 15) // 16
    live = torch.arange(ref.shape[1], device=ref.device)[None, :] < n[:, None]
    return torch.equal(torch.where(live, got, 0), torch.where(live, ref, 0))


def symbols_and_packers(torch, np, synth, digests, card):
    """Phase 10, paths: every packer x sweep on phase 4's 256 frames ==
    fused_mxu, and the symbols API. Returns the launch counts of this run;
    then times each packer (device ms per batch, an observation)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    dev = torch.device("cuda", 0)
    host = phase4_frames(np, synth)
    batches = [torch.from_numpy(host[i:i + B]).to(dev)
               for i in range(0, MAIN_FRAMES, B)]
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    kw = dict(codec=0, width=W, height=H, capacity_words=CAP_WORDS)
    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES)
    reset(counters)
    refs = []
    for frames in batches:
        ref = api.bs_encode_frames_packed(frames, budgets, **kw)
        refs.append(ref)
        for packer in PACKERS:
            for sweep in (True, False):
                out = api.bs_encode_frames_packed(
                    frames, budgets, kernel_sweep=sweep, packer=packer, **kw)
                bad = [k for k in ("scale", "total_bits", "nz_count")
                       if not torch.equal(out[k], ref[k])]
                if not words_equal(torch, out["words"], ref["words"],
                                   ref["total_bits"]):
                    bad.append("words")
                if bad:
                    raise AssertionError(f"packer {packer} (kernel_sweep="
                                         f"{sweep}) differs from fused_mxu "
                                         f"in {bad}")
    say(f"[10] every packer x kernel_sweep equals fused_mxu on "
        f"{MAIN_FRAMES} frames {W}x{H} (scale, total_bits, nz_count, words "
        f"up to each frame's bits): {', '.join(PACKERS)}")

    sym = api.bs_encode_frames(batches[0], budgets, codec=0, width=W,
                               height=H)
    codes, bits = api._with_eof_symbols(sym["codes"], sym["bits"], 0x1FF)
    words, total = bitpack_ops.pack_bits(codes.reshape(B, -1),
                                         bits.reshape(B, -1),
                                         capacity_words=CAP_WORDS)
    ref = refs[0]
    if not (torch.equal(sym["scale"], ref["scale"])
            and torch.equal(sym["nz_count"], ref["nz_count"])
            and torch.equal(total.to(torch.int32), ref["total_bits"])
            and words_equal(torch, bitpack_ops.u16_to_i16(words),
                            ref["words"], ref["total_bits"])):
        raise AssertionError("bs_encode_frames, flat-packed, differs from "
                             "fused_mxu")
    head = {k: v[:SYMBOLS_FRAMES].cpu().numpy() for k, v in sym.items()}
    if symbols_digest(np, head) != digests["symbols_v2"]:
        raise AssertionError("bs_encode_frames differs from the JAX "
                             "package's symbols digest")
    launches = {k: v for c in counters for k, v in c.items()}
    say(f"[10] bs_encode_frames on {B} frames: flat-packed equal to "
        f"fused_mxu; the first {SYMBOLS_FRAMES} frames equal the JAX "
        f"package's digest; launches in phase 10's paths: {launches}")
    for name in ("select_scale", "emit_pack", "place_vals_gather",
                 "place_streams", "pack_block_streams"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in phase 10")

    for packer in PACKERS:
        for sweep in (True, False):
            ms = time_ms(torch, lambda: api.bs_encode_frames_packed(
                batches[0], budgets, kernel_sweep=sweep, packer=packer,
                **kw), reps=3)
            say(f"[10] packer {packer}, kernel_sweep={sweep}: {ms:.3f} ms "
                f"per {B}-frame batch on the device (CUDA events; "
                f"kernels + glue) on {card}")
    return launches


def gather_kernel(torch, k3_inputs, card):
    """Phase 11, K8: K8 == its plain version and == K4 on K3's placement
    prep for phase 10's 128 frames (frame 5 unfittable: its offsets run
    past cap32). Returns K8's row of the kernel table."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    vals32, e0, _, _ = bs_cuda.emit_prep(*k3_inputs, eof=0x1FF)
    results = {}
    lib_fn, lib_words = scatter_add_call(torch, vals32, e0)
    got = compare(torch, results, 11, "place_vals_gather",
                  "(K3's prep of phase 10's frames)",
                  lambda: bitpack_cuda.place_vals_gather(
                      vals32, e0, capacity_words=CAP_WORDS),
                  lambda: bitpack_cuda.place_vals_gather_plain(
                      vals32, e0, capacity_words=CAP_WORDS),
                  (vals32, e0), lambda out: vals32.numel() * OPS_PLACE_WORD,
                  card, library_fn=lib_fn)
    k4 = bitpack_cuda.place_vals(vals32, e0, capacity_words=CAP_WORDS)
    past = int(e0[UNFIT_FRAME, -1]) - (CAP_WORDS + 1) // 2
    if not (torch.equal(got, k4) and torch.equal(got, lib_words)):
        raise AssertionError("K8 differs from K4 or from one scatter_add_")
    say(f"[11] place_vals_gather: equal to K4 and to one scatter_add_ on "
        f"{B} frames; the unfittable frame's last block starts {past} u32 "
        f"words past cap32 (its words there are dropped)")
    if past <= 0:
        raise AssertionError("phase 11: the unfittable frame fits its "
                             "capacity")
    return results["place_vals_gather"]


def _job(argv, src, key, ins, out_dir):
    return ["-q", *argv, os.path.join(ins, src),
            os.path.join(out_dir, out_name(key))]


def _check_outputs(cases, out_dir, digests, what):
    for key, _, _ in cases:
        if file_digest(os.path.join(out_dir, out_name(key))) != digests[key]:
            raise AssertionError(f"{what}: {key} differs from the JAX "
                                 "package's digest")


def batch_phase(torch, digests, tmp, card):
    """Phase 11, the batch runner: BATCH_CASES grouped and serial on the
    card. Returns the launch counts of the grouped run."""
    import contextlib
    import io

    from psxavenc_tpu_torch import batch
    from psxavenc_tpu_torch.ops import adpcm_cuda, bitpack_cuda, bs_cuda

    dev = torch.device("cuda", 0)
    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, adpcm_cuda.LAUNCHES)
    secs = {}
    launches = None
    for mode, group in (("grouped", True), ("serial", False)):
        out_dir = os.path.join(tmp, f"batch_{mode}")
        os.makedirs(out_dir)
        jobs = [_job(argv, src, key, tmp, out_dir)
                for key, argv, src in BATCH_CASES]
        err = io.StringIO()
        reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rcs = batch.run_jobs(jobs, group=group, device=dev)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
        if launches is None:
            launches = {k: v for c in counters for k, v in c.items()}
            for line in err.getvalue().splitlines():
                if line.startswith("[batch]"):
                    say(f"[11] {line}")
        if rcs != [0] * len(jobs):
            raise AssertionError(f"batch ({mode}) exit codes {rcs}: "
                                 f"{err.getvalue()[-2000:]}")
        _check_outputs(BATCH_CASES, out_dir, digests, f"batch ({mode})")
    for key, _, _ in BATCH_CASES:
        a, b = (open(os.path.join(tmp, f"batch_{m}", out_name(key)),
                     "rb").read() for m in ("grouped", "serial"))
        if a != b:
            raise AssertionError(f"batch: {key} grouped != serial")
    say(f"[11] batch runner, {len(BATCH_CASES)} jobs: grouped and serial "
        f"outputs equal each other and the JAX package's digests; wall "
        f"time grouped {secs['grouped']:.3f} s, serial {secs['serial']:.3f} "
        f"s (in process, inputs on the host); launches in the grouped run "
        f"{launches} on {card}")
    for name in ("select_scale_pix", "emit_prep", "place_vals",
                 "adpcm_encode_units"):
        if not launches.get(name):
            raise AssertionError(f"batch: kernel {name} never launched")
    return launches


def streaming_phase(torch, digests, tmp, card):
    """Phase 11, the streaming tier's device path: STREAM_CASES run
    concurrently through batch._run_streaming_audio with small chunks,
    each round of chunks one shared K5 launch. The jobs are opened with
    the whole-file ingest: the streaming ingest needs the FFmpeg
    extension, which a host without FFmpeg's libraries does not build;
    the chunk feeds and the batcher are the same either way."""
    import contextlib
    import io

    from psxavenc_tpu_torch import batch, cli
    from psxavenc_tpu_torch import cli_args as ca
    from psxavenc_tpu_torch.containers import vag as vagmod
    from psxavenc_tpu_torch.containers import xa as xamod
    from psxavenc_tpu_torch.io import ingest

    dev = torch.device("cuda", 0)
    out_dir = os.path.join(tmp, "streaming")
    os.makedirs(out_dir)
    plan = []
    for k, (key, argv, src) in enumerate(STREAM_CASES):
        args = ca.Args()
        if not ca.parse_args(args, _job(argv, src, key, tmp, out_dir)):
            raise AssertionError(f"streaming: bad arguments for {key}")
        plan.append((k, args, ingest.open_av_data(
            args, cli._DECODER_FLAGS[args.format])))
    rcs = [None] * len(plan)
    saved = vagmod.SPU_CHUNK_BLOCKS, xamod.AUDIO_CHUNK_SECTORS_SOLO
    vagmod.SPU_CHUNK_BLOCKS = STREAM_SPU_CHUNK_BLOCKS
    xamod.AUDIO_CHUNK_SECTORS_SOLO = STREAM_XA_CHUNK_SECTORS
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            batch._run_streaming_audio(plan, rcs, dev)
    finally:
        vagmod.SPU_CHUNK_BLOCKS, xamod.AUDIO_CHUNK_SECTORS_SOLO = saved
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rcs != [0] * len(plan):
        raise AssertionError(f"streaming: exit codes {rcs}: "
                             f"{err.getvalue()[-2000:]}")
    _check_outputs(STREAM_CASES, out_dir, digests, "streaming")
    line = [ln for ln in err.getvalue().splitlines()
            if "shared a device call" in ln]
    if not line:
        raise AssertionError("streaming: no chunk round shared a device "
                             "call")
    say(f"[11] streaming tier, {len(plan)} jobs in {secs:.3f} s: equal to "
        f"the digests; {line[0]} on {card}")


def libpsxav_phase(digests, synth, card):
    """Phase 11, libpsxav on the card == its digests."""
    from psxavenc_tpu_torch import libpsxav

    t0 = time.perf_counter()
    outs = libpsxav_outputs(libpsxav, synth, device="cuda")
    secs = time.perf_counter() - t0
    for key, data in outs.items():
        if sha256(data) != digests[key]:
            raise AssertionError(f"libpsxav: {key} differs from the JAX "
                                 "package's digest")
    say(f"[11] libpsxav xa_encode_simple (10 s stereo, "
        f"{len(outs[LIBPSXAV_KEYS[0]])} bytes) and spu_encode_simple (loop "
        f"at {LIBPSXAV_LOOP_START}) equal the JAX package's digests "
        f"({secs:.3f} s) on {card}")


def multi_file(torch, digests, synth, tmp, card):
    """Phase 11's paths: batch runner, streaming tier, libpsxav. Returns
    the launch counts of their run."""
    from psxavenc_tpu_torch.ops import adpcm_cuda, bitpack_cuda, bs_cuda

    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, adpcm_cuda.LAUNCHES)
    grouped = batch_phase(torch, digests, tmp, card)
    reset(counters)
    streaming_phase(torch, digests, tmp, card)
    libpsxav_phase(digests, synth, card)
    total = dict(grouped)
    for c in counters:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    say(f"[11] launches in phase 11's paths (the grouped batch run, the "
        f"streaming tier, libpsxav): {total}")
    return total


def main():
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="smoke_out",
                        help="directory for the ptxas report and profiles")
    out_dir = parser.parse_args().out

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from psxavenc_tpu_torch.ops import _build
    from psxavenc_tpu_torch.utils import synth

    with open(DIGESTS) as f:
        digests = json.load(f)
    card = card_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    try:
        import triton
        has_triton = f"triton {triton.__version__}"
    except ImportError:
        has_triton = "no triton"
    say(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {has_triton} | nvcc: "
        f"{nvcc_ver.splitlines()[-1]}")

    t0 = time.time()
    _build.lib()
    say(f"[2] built {', '.join(_build.SOURCES)} in {time.time() - t0:.1f} s")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(_build.build_log)

    rows = check_kernels(torch, np, synth, card)
    video = main_path(torch, np, synth, digests)
    with tempfile.TemporaryDirectory() as tmp:
        write_inputs(synth, tmp)
        cli_phase(digests, tmp)
        throughput(torch, np, synth, card, out_dir)
        full, ref, rows["adpcm_encode_units"] = adpcm_kernel(torch, np,
                                                             synth, card)
        adpcm_batch(torch, full, ref, card)
        del full, ref
        av = av_path(torch, digests, tmp, card, out_dir)
        k10_rows, k3_inputs = block_stream_kernels(torch, np, synth, card)
        rows.update(k10_rows)
        blocks = symbols_and_packers(torch, np, synth, digests, card)
        rows["place_vals_gather"] = gather_kernel(torch, k3_inputs, card)
        del k3_inputs
        multi = multi_file(torch, digests, synth, tmp, card)

    kernels = []
    for name, source, replaces in KERNELS:
        launches = sum(path.get(name, 0)
                       for path in (video, av, blocks, multi))
        if launches <= 0:
            raise AssertionError(f"kernel {name} launched on no path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
