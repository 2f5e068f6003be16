"""Chip smoke run of psxavenc_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, one or more lines each:

1. the card and toolchain;
2. the kernel build (nvcc, one process per source in
   psxavenc_tpu_torch/csrc, started together), and what ptxas reports for
   the functions of bs_nv21.cu, bs_select.cu, bs_emit.cu, bs_dc.cu,
   bitpack_streams.cu and bitpack_place.cu: registers, stack and spill
   bytes (K2 and K10 must not spill);
3. each BS kernel (the NV21 kernel, whose pixel rows and DCs are the
   other kernels' inputs, K1-K4, and the tail emission of the blocks over
   256 bits, also held to the exact flat packer) against its plain PyTorch
   version at the video path's shapes (BS 320x240, 128 frames, 18,144-byte
   budgets, every eighth frame noise), v2 and v3dc: exact equality; K3's
   cycle sections per frame; the kernel's device time (one wrapper call
   captured as a CUDA graph and replayed back to back, so without the
   host's work), one wrapper call's and the plain version's times (CUDA
   events, median). The NV21 kernel is also checked and timed on the
   batch's first 3 frames (900 macroblocks, no multiple of a CTA's run)
   and on 640x480 frames. K1's scale search is also checked for every kind of
   seed (none, the answers, the answers shifted by +-1 and +-7, all 1, all
   63, out of range) with one frame unfittable, its evaluation statistics
   printed per case and held to the plain model of the search, timed with
   the batch's last scale as every frame's seed and with the answers as
   seeds, run on frames whose subsample misleads it (so that the ladder
   gallops and bisects), and on 640x480 frames, whose rows do not fit
   shared memory. K2 is also checked and timed on v3, on the same DCs made
   all ties (every step depends on the last) and on 640x480 frames, beside
   the floor of a launch (an empty kernel, one CTA and K2's grid), and
   both with ten calls in one graph (the replay's host cost spread over
   them). Every other row under 0.03 ms, and every case of K4 and of the
   tail emission, is also read at ten calls a graph beside an empty launch
   of the kernel's own grid. K8 is also checked and timed on each codec's
   batch beside K4, with its scatter_add_. K4 is also checked against one
   scatter_add_ on one frame, 300 frames, the batch with frame 5
   unfittable (its words run past cap32), 640x480 frames and 16 frames of
   offsets that tie
   (tests/torch_place_cases.py), with the count of its ranges' starts that
   fall inside a block's nine words; the tail emission on noise frames (no
   long block) and on tests/torch_emit_cases.py's edge_inputs, and on every
   case also launched with 1, 2 and 5 CTAs a frame, its count of frames
   with a long block held to theirs;
4. the video path: BsFrameEncoder (pipelined: the next batch uploaded
   and launched while this one is read back and assembled) on the card
   over 256 frames for v2, v3 and v3dc, each codec's bytes equal to its
   committed digest, the NV21 kernel, K1-K4 and the tail emission
   launched, the frames with a block over 256 bits counted on the device;
5. the video CLI (-t sbs, -t strv) as subprocesses on a synthetic AVI,
   equal to the digests (-t strv also with PSXAVENC_PLATFORM=cpu, once
   on the kernels' plain versions and once on the native tiers), each run
   reporting its native library calls: some on the native tiers, none on
   the others;
6. frames/s on video, on video with every eighth frame noise and on a
   batch of noise frames (no block over 256 bits): the device step as the
   median of seven medians with the least and the greatest, and the plain
   path on the card; end to end on 1,024 frames of eight different
   batches, the pipelined encoder and one batch at a time as the median
   of five interleaved pairs with the least and the greatest, both with
   equal bytes, quant-scale sums and overflow counts; the speed of light
   of the step's kernels (utils/roofline.py) and the share of it that the
   device step and the pipelined encoder reach; the step's busy share: the device time of
   each hand-written kernel it launched (each call timed in a CUDA graph
   on the step's own inputs, as in phase 3) and of the whole step timed
   the same way, over the step's CUDA-event time; a torch.profiler list of the
   step's device operations, which must hold no operation that waits for
   the device (nonzero, item) and launch the tail emission, and the same
   list for a fused_pallas step on video+noise (a stream route: K1, K7,
   K9 and the tail emission); and what K1's
   search would do if every batch were seeded with the scale of the frame
   before it (the encoder does not: the statistics say what that would
   buy);
7. K5 against its plain version on 4,096 streams x 64 units for
   (filter_count, shift_range) = (5, 12), (4, 12) and (4, 8), on the
   plan's route (serial) and with 4 segments a stream forced, timed as
   in phase 3;
8. the batch API at full width: api.spu_encode_batch on 4,096 x 1,000
   SPU units, Msamples/s on the device, the kernel's share of its bound
   and of K5's speed of light (utils/roofline.py), peak device memory,
   the plan's route (serial at this shape) beside segments=1, each in a
   CUDA graph; then K5 on one long file, the two streams of a 60 s stereo
   37,800 Hz XA track of synthetic audio and of a 440 Hz tone at 30,000
   (where guessed states never merge): the plan's segments equal the
   native unit encoder and the plain model of the scheme, the kernels'
   stats (segments, speculation, repair, rounds, walk) equal the model's,
   both timed in a CUDA graph beside segments=1 and the native tier's
   host time; then K5 on the shared row, as the batch runner's grouped
   call hands it over: mono clips at a sound bank's lengths (256,
   0.1-5 s log-uniform at 44,100 Hz; the serial route) and at eight
   15-30 s loops' (the plan's segments), each with an empty stream whose
   units have positive limits, and the XA track's two channels by their
   chunk offsets beside an empty third: on the plan's route and with
   ADPCM_FORCED_SEGMENTS, equal to the native tier on the host's gather
   and to the plain version on the first units, one "shared_row" input
   and the route's launches a call, timed in a CUDA graph beside the
   dense layout on the clips zero-padded;
9. the audio and A/V path: the CLI (-t xa, xacd, spu, vag, vagi, and the
   flagship -t strcd / -t str: 320x240 15 fps BS v2 with 37,800 Hz stereo
   XA) run in this process on the card, every output equal to its
   digest, K5 (and K1, K3, K4 for str/strcd) launched; seconds per file
   and, from torch.profiler, K5's device time (all of its kernels) on
   the 60 s track; the
   flagship strcd once more with PSXAVENC_PROFILE set to a directory
   under --out: its Chrome trace names K1's kernel, stderr says "Profile
   written to", the output equals its digest;
10. the symbols API and the per-block-stream packers at the video path's
   width: K6, K7 (both coefficient forms), K9 and K10 against their plain
   versions on phase 4's first 128 frames (video+noise, one frame's
   budget cut to 200 bytes: unfittable), timed as in phase 3 (K9 through
   its u32 entry point, the placement that fused_pallas runs, against one
   scatter_add_, and through its u16 wrapper, the JAX signature); the tail
   emission on the same frames (the unfittable one runs past the
   capacity), both coefficient forms; K10's achieved GB/s, and K10 on
   adversarial rows (tests/torch_dc_pack_cases.py: codes with their top
   bit set or garbage above their length, 0-bit symbols between, rows of
   256, 257 and far over 256 bits, all-zero rows; S = 65, 17, 130 and
   600); K6's seed
   cases as K1's in phase 3, K6 on the misleading frames, on 640x480
   frames and on a frame with a coefficient over 16 bits; every packer of
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
   digests;
12. parallel.mesh's batch split over the card listed twice (and over
   every visible card when there are several): packed_video_step (v3dc)
   and unit_encode_step equal the single-device calls, with the shards'
   shapes and torch.cuda.device_count() printed;
13. the card against the port's native C++ tiers (native/tiers.py, built
   with g++ on the card's host): api.bs_encode_frames_packed in B-frame
   batches equals the native frame encoder on 2,048 frames a codec at
   320x240 (v2, v3, v3dc) and on 16x16, 48x32 and 640x480 frames, in
   phase 6's three mixes with random budgets that leave some frames
   unfittable (the scale of every frame; words, total bits and nonzero
   counts of every frame that fits); BsFrameEncoder on the CPU with
   PSXAVENC_VIDEO_TIER=native (refused on the card) equals the card's
   encoder, which makes no native call, on phase 6's 1,024 frames of each mix; K5 equals the
   native unit encoder on 256 random streams x 300 units for the three
   variants and on a 60 s stereo XA track's two streams (81,000 units
   each); the native tier's frames/s and units/s on the host, with its
   core count;
14. bench_torch.py --quick in a subprocess on the card (its validation,
   one repetition of each measurement, no details file): exit 0, and a
   last line whose value is over 0 and whose device is the card's name;
   the line is printed.

The digests (psxavenc_tpu_torch/data/smoke_digests.json) are the JAX
package's outputs for the same inputs; tests/test_torch_smoke_refs.py
recomputes them on the CPU from the recipes below. The ptxas report, the
profiler tables and phase 9's trace are written under ``--out`` (default
``smoke_out/``). Every bound is a work function of
psxavenc_tpu_torch/utils/roofline.py on the call's shapes and data.

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

from psxavenc_tpu_torch.utils import roofline as rl

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
ADPCM_FORCED_SEGMENTS = 4            # phase 7's segmented run (16 units)
SYMBOLS_FRAMES = 8                   # frames of the symbols_v2 digest
UNFIT_FRAME, UNFIT_BUDGET = 5, 200   # the unfittable frame of the checks
MODEL_FRAMES = 16                    # frames the search's plain model runs
BIG_W, BIG_H, BIG_FRAMES = 640, 480, 6   # rows too long for shared memory
PACKERS = ("fused_mxu", "fused", "fused_pallas", "fused_gather", "blocks",
           "blocks_pallas", "flat")

# (wrapper name, source, TPU kernel it replaces)
KERNELS = [
    # No TPU kernel: the XLA glue in front of the fused select (the pixel
    # rows, and the DC sums of psxavenc_tpu/ops/bs.py:742).
    ("nv21_pix_dc", "psxavenc_tpu_torch/csrc/bs_nv21.cu",
     "psxavenc_tpu/api.py:96"),
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
    # No TPU kernel: the flat re-pack that the JAX package leaves to XLA.
    ("emit_tail", "psxavenc_tpu_torch/csrc/bs_emit.cu",
     "psxavenc_tpu/api.py:212"),
]

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
# Phase 13: the card against the port's native C++ tiers.
NATIVE_FRAMES = 2048                 # frames a codec at 320x240
NATIVE_GEOMETRIES = ((16, 16, 96), (48, 32, 192), (640, 480, 96))
NATIVE_STREAMS, NATIVE_UNITS = 256, 300
XA_TRACK_UNITS = 37800 * 60 // 28    # a 60 s 37,800 Hz channel: 81,000
# Phase 8's shared rows: (label, clips, shortest and longest seconds,
# spacing), a grouped job list's mono 44,100 Hz clips.
SHARED_ROW_LISTS = (("bank", 256, 0.1, 5.0, "log"),
                    ("long", 8, 15.0, 30.0, "linear"))


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


def nv21(np, planes, w=W, h=H):
    y, cb, cr = planes
    c = np.stack([cr.reshape(h // 2, w // 2), cb.reshape(h // 2, w // 2)],
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


def mix_frames(np, synth, n, w, h, seed):
    """n NV21 w x h frames in phase 6's three mixes, a third each:
    synthetic video, video with every eighth frame noise, and noise."""
    rng = np.random.default_rng(seed)
    parts = []
    for k, every in enumerate((0, 8, None)):
        m = n // 3 + (k < n % 3)
        if every is None:
            parts.append(rng.integers(0, 256, (m, w * h * 3 // 2))
                         .astype(np.uint8))
            continue
        out = []
        for i, planes in enumerate(synth.rand_frames(w, h, m,
                                                     seed=seed + k)):
            if every and i % every == every - 1:
                out.append(rng.integers(0, 256, w * h * 3 // 2)
                           .astype(np.uint8))
            else:
                out.append(nv21(np, planes, w, h))
        parts.append(np.stack(out))
    return np.concatenate(parts)


def mix_budgets(np, n, w, h, seed):
    """n random byte budgets from half a byte a block to 20 bytes a block:
    the low ones leave frames that fit at no scale."""
    blocks = w * h // 256 * 6
    rng = np.random.default_rng(seed)
    return rng.integers(max(16, blocks // 2), blocks * 20, n).astype(
        np.int32)


def xa_track_units(np, synth, seed=61):
    """The two channel streams of a 60 s stereo 37,800 Hz XA track as
    (2, XA_TRACK_UNITS, 28) int32 units, full limits and zero states."""
    pcm = synth.rand_pcm(XA_TRACK_UNITS * 28, channels=2, seed=seed)
    units = np.ascontiguousarray(pcm.reshape(-1, 2).T, dtype=np.int32)
    lim = np.full((2, XA_TRACK_UNITS), 28, np.int32)
    zero = np.zeros(2, np.int32)
    return units.reshape(2, XA_TRACK_UNITS, 28), lim, zero, zero


def xa_chunk_layout(np, synth, seed=61):
    """The 60 s stereo track's two streams as the XA CLI hands them to K5
    (containers/xa.py::XaAudioSectors): (2, N) int16 PCM and (2, T) int32
    offsets and limits, 72 units a sector at 28 k from the sector's start.
    Every 97th sector is 13 samples short and the last 1,000, so offsets
    leave the 28-grid and the tail's units read past the end."""
    per_sector = 72
    lengths = np.full(XA_TRACK_UNITS // per_sector, 28 * per_sector)
    lengths[96::97] -= 13
    lengths[-1] -= 1000
    pcm = synth.rand_pcm(int(lengths.sum()), channels=2, seed=seed)
    pcm = np.ascontiguousarray(pcm.T)
    prefix = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    k = 28 * np.arange(per_sector)
    offs = (prefix[:, None] + k).reshape(-1)
    lim = np.clip((lengths[:, None] - k).reshape(-1), -(1 << 30), 28)
    return (pcm, np.stack([offs, offs]).astype(np.int32),
            np.stack([lim, lim]).astype(np.int32))


def clip_lengths(np, clips, lo, hi, spacing, rate=44100):
    """Sample counts of a job list's clips: ``clips`` quantiles of a
    log-uniform (``spacing`` "log") or uniform law over [lo, hi] s."""
    q = (np.arange(clips) + 0.5) / clips
    sec = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo))) \
        if spacing == "log" else lo + q * (hi - lo)
    return [int(round(x * rate)) for x in sec]


def shared_row_clips(np, synth, lengths, seed):
    """The grouped call's input for mono SPU clips of ``lengths`` samples
    and one empty stream after them: the (N,) int16 shared row, each
    stream's start and length, no offsets (28-sample blocks), the (B, T)
    limits zero-padded to the longest clip (the empty stream's first
    three units at 28, which K5 masks) and carried-in states."""
    n = np.asarray(list(lengths) + [0], np.int64)
    row = synth.rand_pcm(int(n.sum()), seed=seed)
    base = np.concatenate([[0], np.cumsum(n)[:-1]])
    T = int(-(-n.max() // 28))
    k = 28 * np.arange(T)
    lim = np.where(k < n[:, None], np.minimum(n[:, None] - k, 28), 0)
    lim[-1, :3] = 28
    rng = np.random.default_rng(seed)
    p1, p2 = rng.integers(-0x8000, 0x8000, (2, len(n))).astype(np.int32)
    return row, None, lim.astype(np.int32), base, n, p1, p2


def shared_row_xa(np, synth):
    """The XA track's two channels (``xa_chunk_layout``) as one shared row
    by their chunk offsets, and an empty third stream that starts at the
    row's end, its units at 28 (masked); zero states."""
    pcm, offs, lim = xa_chunk_layout(np, synth)
    N = pcm.shape[1]
    lim = np.concatenate([lim, np.full((1, lim.shape[1]), 28, np.int32)])
    zero = np.zeros(3, np.int32)
    return (pcm.reshape(-1), np.concatenate([offs, offs[:1]]), lim,
            np.array([0, N, 2 * N]), np.array([N, N, 0]), zero, zero)


def tone_track_units(np, synth):
    """The two channel streams of a 60 s stereo 37,800 Hz track of a 440 Hz
    tone at 30,000 (synth.tone), the case where guessed ADPCM states stay
    on other limit cycles: (2, XA_TRACK_UNITS, 28) int32 units, full limits
    and zero states."""
    pcm = synth.tone(XA_TRACK_UNITS * 28, channels=2)
    units = np.ascontiguousarray(pcm.T, dtype=np.int32)
    lim = np.full((2, XA_TRACK_UNITS), 28, np.int32)
    zero = np.zeros(2, np.int32)
    return units.reshape(2, XA_TRACK_UNITS, 28), lim, zero, zero


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


# Rows whose one call a graph reads under this are read again at ten calls
# a graph (small_row): below it the replay's own host cost is a large part
# of what one call a graph reads.
SMALL_MS = 0.03


def graph_ms(torch, fn, reps=20, calls=1):
    """Mean device milliseconds of fn's work: one call (or ``calls`` calls,
    and then the time of one) captured as a CUDA graph, replayed ``reps``
    times back to back between CUDA events, so the host's work per call
    (argument checks, allocation, the launch itself) is not in it. Where
    the work is shorter than the replay's own host cost (5-8 us a replay
    on the card's host, PERF.md), one call a graph times that cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
    return a.elapsed_time(b) / (reps * calls)


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


def small_row(torch, tag, name, label, kernel_fn, grid, card,
              library_fn=None):
    """A row under SMALL_MS read again at ten calls a graph, where the
    replay's host cost is spread over ten calls: the kernel, one PyTorch
    call (``library_fn``, where given) and, where ``grid`` (CTAs, threads a
    CTA) is given, an empty kernel of that grid at one and at ten calls a
    graph. Returns the row's new keys."""
    from psxavenc_tpu_torch.ops import bs_cuda

    row = {"ten_ms": graph_ms(torch, kernel_fn, calls=10)}
    text = f"kernel {row['ten_ms']:.4f} ms a call"
    if library_fn:
        row["library_ten_ms"] = graph_ms(torch, library_fn, calls=10)
        text += f", one PyTorch call {row['library_ten_ms']:.4f}"
    if grid:
        t = torch.empty(0, device="cuda")
        row["empty_ms"] = graph_ms(
            torch, lambda: bs_cuda.empty_launch(t, *grid))
        row["empty_ten_ms"] = graph_ms(
            torch, lambda: bs_cuda.empty_launch(t, *grid), calls=10)
        text += (f"; an empty kernel of its grid ({grid[0]} CTAs of "
                 f"{grid[1]} threads) {row['empty_ten_ms']:.4f} ms a call "
                 f"(one call a graph: {row['empty_ms']:.4f})")
    say(f"[{tag}] {name} {label}, ten calls a graph: {text} on {card}")
    return row


def compare(torch, results, tag, name, label, kernel_fn, plain_fn, work_fn,
            card, library_fn=None, grid=None, size=f"B={B}, {W}x{H}",
            ten=False):
    """The kernel == its plain version, exactly; prints and keeps (the
    first time per name) the wrapper's device time (``graph_ms``), the
    wrapper call's and the plain version's times (CUDA events, median)
    and the bound of ``work_fn(out)``: the (bytes, operations) of this
    run's call, from the kernel's work function in utils/roofline.py.
    ``library_fn`` is one PyTorch call computing the same function, timed
    as the wrapper is. A kernel under SMALL_MS (any, with ``ten``) is also
    read by ``small_row``, beside an empty launch of ``grid`` where
    given."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want, name)
    ms = graph_ms(torch, kernel_fn)
    call_ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn, reps=3)
    library_ms = graph_ms(torch, library_fn) if library_fn else None
    bound_ms, bound_by = rl.bound(*work_fn(got))
    lib = f", one PyTorch call {library_ms:.4f} ms" if library_fn else ""
    say(f"[{tag}] {name} {label}: max |kernel - plain| = {err}; kernel "
        f"{ms:.4f} ms on the device (graph replay; one wrapper call "
        f"{call_ms:.4f} ms with its host work), plain {plain_ms:.4f} ms{lib}, "
        f"bound {bound_ms:.4f} ms ({bound_by}) ({size}) on {card}")
    if err:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    if ten or ms < SMALL_MS:
        row.update(small_row(torch, tag, name, label, kernel_fn, grid, card,
                             library_fn))
    results.setdefault(name, row)
    return got


def select_work_of(torch, nb, fdct):
    """The work of K1 (with ``fdct``) or K6 on its output: the data needs
    the exact total at the chosen scale and at the scale below it (one
    evaluation for scale 1 and for unfittable frames)."""
    def work(out):
        evals = int(torch.where((out[0] > 1) & (out[0] <= 63), 2, 1).sum())
        if fdct:
            return rl.fdct_select_work(out[0].shape[0], nb, out[3].shape[2],
                                       evals)
        return rl.select_work(out[0].shape[0], nb, evals)
    return work


def emit_work_of(fn, coefs, sidx, nb):
    """``fn`` (rl.emit_prep_work or rl.emit_pack_work) on ``coefs`` at the
    scales ``sidx``: their bytes and this run's nonzero levels."""
    n = rl.nonzero_count(coefs, sidx, nb)
    return lambda out: fn(coefs.shape[0], nb, rl.nbytes(coefs), n)


def place_work_of(e0):
    """The work of K4 or K8 on K3's offsets ``e0`` (B, NBe)."""
    return lambda out: rl.place_work(*e0.shape, out.shape[1])


def place_streams_work_of(goff):
    """The work of K9 on the block offsets ``goff`` (B, NBe)."""
    return lambda out: rl.place_streams_work(*goff.shape, out.shape[1])


def select_inputs(torch, frames, budgets, w=W, h=H):
    """K1's inputs for NV21 ``frames`` on the card (BS v2): the pixel rows
    and the AC fit thresholds of ``budgets``."""
    from psxavenc_tpu_torch.ops import bs as bs_ops

    pix = bs_ops.rearrange_nv21_rows(frames, w, h)
    dc_bits, _ = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                  bs_ops.BS_V2)
    return pix, bs_ops.ac_threshold(
        budgets, dc_bits.sum(dim=1, dtype=torch.int32), pix.shape[2])


def seed_cases(torch, answers):
    """(name, seeds) for a batch whose scales are ``answers``."""
    b = answers.shape[0]
    dev = answers.device
    odd = torch.tensor([0, 64, -5], dtype=torch.int32,
                       device=dev)[torch.arange(b, device=dev) % 3]
    return [("none", None), ("the answers", answers.clamp(max=63)),
            ("answers + 1", answers + 1), ("answers - 1", answers - 1),
            ("answers + 7", answers + 7), ("answers - 7", answers - 7),
            ("all 1", torch.ones_like(answers)),
            ("all 63", torch.full_like(answers, 63)),
            ("0, 64, -5 (out of range)", odd)]


def stats_text(torch, stats):
    """Per-frame means of a kernel's statistics output."""
    m = stats.to(torch.float64).mean(dim=0).tolist()
    hits = int(((stats[:, 0] == 0) & (stats[:, 2] == 0)
                & (stats[:, 3] == 1)).sum())
    return (f"per frame {m[0]:.3f} ladder evaluations, {m[1]:.3f} fused "
            f"passes, {m[2]:.3f} exact evaluations, {m[3]:.3f} self-seeding "
            f"rounds; {hits} of {stats.shape[0]} frames done after one round "
            f"and the fused pass; reader: {int((stats[:, 4] == 0).sum())} "
            f"shared, {int((stats[:, 4] == 1).sum())} global; kcycles before "
            f"the search {m[5] / 1e3:.1f}, self-seeding {m[6] / 1e3:.1f}, "
            f"evaluations {m[7] / 1e3:.1f}, in all {sum(m[5:]) / 1e3:.1f} "
            f"(slowest frame "
            f"{int(stats[:, 5:].sum(dim=1).max()) / 1e3:.1f})")


def check_seed_cases(torch, tag, name, kernel, want, c_abs, thr, threads,
                     card):
    """A select kernel against its plain answers ``want`` for every seed
    case, exactly; its statistics per case; and its counts on the first
    MODEL_FRAMES frames against the plain model of the search.
    ``kernel(seeds, stats)`` launches it. Returns the no-seed statistics."""
    from psxavenc_tpu_torch.ops import bs_cuda

    b, _, nb = c_abs.shape
    groups = bs_cuda.search_groups(nb, threads)
    head = slice(0, min(b, MODEL_FRAMES))
    cold = None
    for case, seeds in seed_cases(torch, want[0]):
        stats = torch.full((b, len(bs_cuda.STAT_NAMES)), -1,
                           dtype=torch.int32, device=c_abs.device)
        got = kernel(seeds, stats)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want, name)
        model = bs_cuda.select_search_plain(
            c_abs[head], thr[head], None if seeds is None else seeds[head],
            groups)
        same = (torch.equal(stats[head, :bs_cuda.COUNT_STATS],
                            model[3][:, :bs_cuda.COUNT_STATS])
                and all(torch.equal(m, w[head])
                        for m, w in zip(model[:3], want)))
        say(f"[{tag}] {name} seeds {case}: max |kernel - plain| = {err}; "
            f"{stats_text(torch, stats)}; first {head.stop} frames' counts "
            f"equal the plain model's: {same} (on {card})")
        if err or not same or (stats[:, 4] != 0).any():
            raise AssertionError(f"{name}, seeds {case}: the kernel "
                                 "disagrees with its plain version, the "
                                 "plain model, or did not read shared "
                                 "memory")
        if seeds is None:
            cold = stats
    new = cold.to(torch.float64).mean(dim=0).tolist()
    say(f"[{tag}] {name} without seeds, evaluations of the whole frame per "
        f"frame: {new[0] + 2 * new[1] + new[2]:.3f} (a fused pass counts as "
        f"two) plus {new[3]:.3f} rounds of {groups} scales on an eighth of "
        f"the frame")
    return cold


def check_misleading(torch, tag, name, pix, threads, launch, card):
    """A select kernel on MODEL_FRAMES frames whose subsample misleads its
    search by many scales (bs_cuda.misleading_frames: flat there, or flat
    everywhere else), without seeds and with wrong ones: the stepping
    passes run out, so every frame gallops and bisects with full ladder
    evaluations. The answers equal the plain version's and the counts the
    plain model's. ``launch(pix, c, thr, seeds, stats)`` runs the
    kernel."""
    from psxavenc_tpu_torch.ops import bs as bs_ops
    from psxavenc_tpu_torch.ops import bs_cuda

    pix, thr = bs_cuda.misleading_frames(pix[:MODEL_FRAMES])
    c = bs_ops.pixrows_to_coefs_zz(pix).contiguous()
    want = bs_cuda.select_scale_plain(c, thr)
    groups = bs_cuda.search_groups(c.shape[2], threads)
    for case, seeds in (("none", None), ("answers + 7", want[0] + 7)):
        stats = torch.full((c.shape[0], len(bs_cuda.STAT_NAMES)), -1,
                           dtype=torch.int32, device=c.device)
        got = launch(pix, c, thr, seeds, stats)[:3]
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want, name)
        model = bs_cuda.select_search_plain(c.abs(), thr, seeds, groups)
        same = (torch.equal(stats[:, :bs_cuda.COUNT_STATS],
                            model[3][:, :bs_cuda.COUNT_STATS])
                and all(torch.equal(m, w) for m, w in zip(model[:3], want)))
        say(f"[{tag}] {name} on {c.shape[0]} frames whose subsample "
            f"misleads (scales {int(want[0].min())}..{int(want[0].max())}), "
            f"seeds {case}: max |kernel - plain| = {err}; "
            f"{stats_text(torch, stats)}; least ladder evaluations of a "
            f"frame {int(stats[:, 0].min())}; counts equal the plain "
            f"model's: {same} (on {card})")
        if err or not same or int(stats[:, 0].min()) < 1:
            raise AssertionError(f"{name} on misleading frames, seeds "
                                 f"{case}: wrong answer, counts unlike the "
                                 "plain model's, or no gallop")


def lane_balance(torch, tag, c_abs, scale):
    """How evenly pass B's work falls on a warp's lanes: the nonzero levels
    of each pair of blocks at the frame's scale, summed per warp as the
    kernel waits for them (the busiest lane of 32) over the same work
    spread evenly, with the pairs in natural order and in the kernels'
    order (a warp's lanes take pairs of one kind: chroma, upper luma,
    lower luma)."""
    from psxavenc_tpu_torch.ops import bs as bs_ops

    keep = (scale >= 1) & (scale <= 63)
    ca, s = c_abs[keep], scale[keep].to(torch.int32)
    d = bs_ops.quant_zz(ca.device)[None, :, None] * s[:, None, None]
    nz = ((ca + (d >> 1)) >= d).sum(dim=1)                  # (B, NB)
    pairs = nz[:, 0::2] + nz[:, 1::2]
    n = pairs.shape[1]
    third = n // 3
    i = torch.arange(n, device=ca.device)
    orders = {"natural": i, "by kind": 3 * (i % third) + i // third}
    parts = []
    for label, order in orders.items():
        p = pairs[:, order]
        p = torch.nn.functional.pad(p, (0, -n % 32)).reshape(len(p), -1, 32)
        ratio = float(p.max(dim=2).values.sum() * 32) / float(pairs.sum())
        parts.append(f"{label} x{ratio:.2f}")
    say(f"[{tag}] pass B over {len(ca)} frames at their scales: "
        f"{float(nz.to(torch.float64).mean()):.1f} nonzero levels a block; "
        f"the warps' busiest lanes against evenly spread work: "
        f"{', '.join(parts)}")


def seeded_times(torch, tag, name, row, kernel, want, stats, evals_bound,
                 groups, card):
    """Adds to ``row`` the kernel's device time with every frame seeded
    with the batch's last scale (what carrying a seed from batch to batch
    would give) and with the answers as seeds; prints how the cold time's
    distance from the bound splits into more evaluations and slower
    evaluations."""
    from psxavenc_tpu_torch.ops import bs_cuda

    answers = want[0].clamp(max=63)
    carried = answers[-1:].expand(answers.shape[0]).contiguous()
    row["seeded_ms"] = graph_ms(torch, lambda: kernel(carried, None))
    row["hit_ms"] = graph_ms(torch, lambda: kernel(answers, None))
    m = stats.to(torch.float64).mean(dim=0).tolist()
    work = m[0] + 2 * m[1] + m[2] + m[3] * groups / bs_cuda.SUBSAMPLE
    ratio = row["ms"] / row["bound_ms"]
    say(f"[{tag}] {name}: kernel {row['ms']:.4f} ms without seeds, "
        f"{row['seeded_ms']:.4f} ms with the last frame's scale as every "
        f"frame's seed, {row['hit_ms']:.4f} ms with the answers as seeds "
        f"(graph replay); without seeds it is x{ratio:.2f} its bound of "
        f"{row['bound_ms']:.4f} ms: x{work / evals_bound:.2f} from "
        f"evaluating {work:.2f} frames' worth per frame where the bound "
        f"counts {evals_bound:.2f}, x{ratio * evals_bound / work:.2f} from "
        f"evaluating slower than the card's int32 rate (on {card})")


def big_frames(torch, np, synth):
    """BIG_FRAMES NV21 frames of BIG_W x BIG_H on the card, their budgets
    (four times 320x240's; one unfittable), pixel rows and thresholds."""
    host = np.stack([nv21(np, p, BIG_W, BIG_H) for p in synth.rand_frames(
        BIG_W, BIG_H, BIG_FRAMES, seed=17)])
    frames = torch.from_numpy(host).to(torch.device("cuda", 0))
    budgets = torch.full((BIG_FRAMES,), 4 * BUDGET, dtype=torch.int32,
                         device=frames.device)
    budgets[1] = UNFIT_BUDGET
    return select_inputs(torch, frames, budgets, BIG_W, BIG_H)


def check_big(torch, tag, name, kernel, plain, c, thr, card):
    """A select kernel on frames whose rows do not fit shared memory:
    equal to its plain version without seeds and with wrong ones, every
    frame read from global memory."""
    from psxavenc_tpu_torch.ops import bs_cuda

    want = plain()
    for case, seeds in (("none", None), ("answers + 1", want[0] + 1)):
        stats = torch.full((c.shape[0], len(bs_cuda.STAT_NAMES)), -1,
                           dtype=torch.int32, device=c.device)
        got = kernel(seeds, stats)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want, name)
        say(f"[{tag}] {name} on {c.shape[0]} frames {BIG_W}x{BIG_H} (NB = "
            f"{c.shape[2]}), seeds {case}: max |kernel - plain| = {err}; "
            f"scales {want[0].tolist()}; {stats_text(torch, stats)}")
        if err or not (stats[:, 4] == 1).all():
            raise AssertionError(f"{name} at {BIG_W}x{BIG_H}: wrong answer "
                                 "or not the global-memory reader")


def ptxas_report(log, source, entries):
    """Phase 2: registers, stack and spill bytes that ptxas reports for
    each function of ``source`` (from the build's ``-Xptxas -v`` output):
    the kernels named in ``entries`` (a template's instance with its
    argument: a flag, int32 or int16), and the functions they call but do
    not inline. Returns {short name: spill bytes (stores + loads)}."""
    import re

    section = log.partition(f"== {source}\n")[2].partition("\n== ")[0]
    found = re.findall(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads(?:\s+ptxas info\s+: "
        r"Used (\d+) registers)?", section)
    if not found:
        raise AssertionError(f"no ptxas report for {source} in the build's "
                             "output")
    kernel = ""
    spills = {}
    for name, stack, stores, loads, regs in found:
        entry = next((k for k in entries if k in name), None)
        if entry:
            m = re.search(entry + r"I(?:Lb(\d)|([is]))E", name)
            arg = "" if not m else f"<{m[1]}>" if m[1] else \
                {"i": "<int32>", "s": "<int16>"}[m[2]]
            kernel, short = entry, entry + arg
        else:
            # partial_totals<kEx, Reader>, listed after the kernel calling it
            m = re.search(r"\d+([a-z_]+)ILb(\d)E.*?(\w+Reader)", name)
            short = (f"{kernel}'s {m[1]}<kEx={m[2]}, {m[3][-12:]}>" if m
                     else name[-40:])
        used = f"{regs} registers, " if regs else ""
        say(f"[2] ptxas {source} {short}: {used}{stack} bytes stack frame, "
            f"{stores} bytes spill stores, {loads} bytes spill loads")
        spills[short] = int(stores) + int(loads)
    return spills


def emit_stats_line(torch, tag, coefs, emit_args, eof, card):
    """K3's cycle sections (its ``stats_out``), means over the frames, and
    how unevenly its walk fills the warps."""
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    stats = torch.zeros((coefs.shape[0], len(bs_cuda.EMIT_STAT_NAMES)),
                        dtype=torch.int32, device=coefs.device)
    bs_cuda.emit_prep(coefs, *emit_args, eof=eof, stats_out=stats)
    torch.cuda.synchronize()
    st = stats.to(torch.float64)
    parts = ", ".join(f"{name[:-7]} {v:.0f}" for name, v in zip(
        bs_cuda.EMIT_STAT_NAMES, st.mean(dim=0).tolist()))
    whole = st[:, [0, 3, 4, 5]].sum(dim=1)
    say(f"[{tag}] emit_prep SM cycles per frame (one warp's clock, means "
        f"over {len(st)} frames): {parts}; the whole CTA (tables + emit + "
        f"scan + store) {float(whole.mean()):.0f}, slowest frame "
        f"{float(whole.max()):.0f} (on {card})")
    # The walk lasts as long as a warp's busiest lane: the nonzero levels of
    # every block, laid out over the trips' threads as the kernel does.
    nb = emit_args[1].shape[1]
    d = (bs_ops.quant_zz(coefs.device)[None, :, None]
         * emit_args[0][:, None, None])
    count = (coefs[:, :63, :nb].abs() >= (d + 1) >> 1).sum(dim=1)
    width = bs_cuda.emit_threads(nb)
    t = torch.arange(width, device=coefs.device)
    column = (t % (width // 6)) * 6 + t // (width // 6)
    steps = 0
    for n0 in range(0, nb, width):
        n = n0 + column
        lanes = torch.where(n < nb, count[:, n.clamp(max=nb - 1)], 0)
        steps += int(lanes.reshape(len(st), -1, 32).max(dim=2).values.sum())
    say(f"[{tag}] emit_prep walk: {float(count.float().mean()):.2f} nonzero "
        f"levels a block; its warps take {steps} steps of a nonzero each in "
        f"all, x{32 * steps / int(count.sum()):.2f} of evenly filled warps")
    if not (stats[:, [0, 1, 2, 3, 4, 5]] > 0).all():
        raise AssertionError("emit_prep: a cycle section is empty")


def tail_launch(torch, out32, coefs, emit_args, block_bits, ctas, count):
    """The tail emission's kernel launched with ``ctas`` CTAs a frame
    (the wrapper picks its own: ops/bs_cuda.py:tail_ctas), ORing into
    ``out32`` and adding to ``count``; not counted in LAUNCHES."""
    from psxavenc_tpu_torch.ops import _build

    scale, _, dc_bits = emit_args
    b, rows, stride = coefs.shape
    _build.launch("psx_emit_tail", coefs, _build.ptr(coefs),
                  int(coefs.dtype == torch.int16), b, rows, stride,
                  block_bits.shape[1], _build.ptr(scale), _build.ptr(dc_bits),
                  _build.ptr(block_bits), ctas, out32.shape[1], CAP_WORDS,
                  _build.ptr(out32), _build.ptr(count))


def check_tail(torch, results, tag, label, placed, coefs, emit_args,
               block_bits, eof, card, size=f"B={B}, {W}x{H}"):
    """The tail emission on ``placed`` (the placement kernel's words, which
    hold every block's first 256 bits) == its plain version and, as u16
    words, == the exact flat packer on the same frames; it counts the
    frames that have a block over 256 bits, once each, also when its
    kernel is launched with 1, 2 and 5 CTAs a frame. Timed by
    ``tail_compare``, at one and at ten calls a graph."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bs_cuda

    kw = dict(capacity_words=CAP_WORDS)
    long_blocks = block_bits > 256
    n_long = int(long_blocks.sum())
    n_frames = int(long_blocks.any(dim=1).sum())
    first, counted = bs_cuda.emit_tail(placed.clone(), coefs, *emit_args,
                                       block_bits, **kw)
    flat = api._overflow_words(coefs, emit_args[0] - 1, emit_args[2],
                               emit_args[1], eof, CAP_WORDS)
    torch.cuda.synchronize()
    same = torch.equal(bitpack_ops.words_u16(first, CAP_WORDS), flat)
    say(f"[{tag}] emit_tail {label}: {n_frames} of {placed.shape[0]} frames "
        f"have a block over 256 bits ({n_long} blocks, the longest "
        f"{int(block_bits.max())} bits, longest frame "
        f"{int(block_bits.sum(dim=1).max()) + 10} bits of {16 * CAP_WORDS}); "
        f"counted on the device: {int(counted)}; K3 + K4 + the tail emission "
        f"equal the exact flat packer: {same}")
    if not same or int(counted) != n_frames:
        raise AssertionError("emit_tail: the words differ from the flat "
                             "packer's, or the frames were miscounted")
    grid = bs_cuda.emit_tail_grid(block_bits.shape[0])
    agree = []
    for ctas in (1, 2, 5):
        out = placed.clone()
        count = torch.zeros((1,), dtype=torch.int32, device=placed.device)
        tail_launch(torch, out, coefs, emit_args, block_bits, ctas, count)
        torch.cuda.synchronize()
        agree.append(torch.equal(out, first) and int(count) == n_frames)
    say(f"[{tag}] emit_tail {label}: the wrapper launches "
        f"{grid[0] // block_bits.shape[0]} CTAs a frame; launched with 1, 2 "
        f"and 5 CTAs a frame, the same words and count: {agree}")
    if not all(agree):
        raise AssertionError("emit_tail: the words or the count depend on "
                             "the CTAs a frame")
    tail_compare(torch, results, tag, label, placed, coefs, emit_args,
                 block_bits, card, grid, size)
    return n_frames


def tail_compare(torch, results, tag, label, placed, coefs, emit_args,
                 block_bits, card, grid, size=f"B={B}, {W}x{H}"):
    """The tail emission on ``placed`` == its plain version, timed by
    ``compare`` (the launch of ``grid``): the replayed launch ORs the same
    bits into its words again. The bound counts the block totals read once
    and, per long block, its column of coefficients and the words its tail
    touches."""
    from psxavenc_tpu_torch.ops import bs_cuda

    kw = dict(capacity_words=CAP_WORDS)
    long_blocks = block_bits > 256
    n_long = int(long_blocks.sum())
    tail_bytes = int((block_bits - 256).clamp(min=0).sum()) // 8
    scratch = placed.clone()
    count = torch.zeros((1,), dtype=torch.int32, device=placed.device)
    return compare(
        torch, results, tag, "emit_tail", label,
        lambda: bs_cuda.emit_tail(scratch, coefs, *emit_args, block_bits,
                                  count=count, **kw)[0],
        lambda: bs_cuda.emit_tail_plain(placed, coefs, *emit_args,
                                        block_bits, **kw)[0],
        lambda out: rl.tail_work(
            *block_bits.shape, n_long,
            rl.nonzero_count(coefs, emit_args[0], block_bits.shape[1],
                             long_blocks),
            coefs.element_size(), tail_bytes),
        card, grid=grid, size=size, ten=True)


def check_kernels(torch, np, synth, card):
    """Phase 3: each BS kernel == its plain version; returns the timings
    and bounds of the first check of each."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(smoke_frames(np, synth, B, seed=5)).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    results = {}

    def check(*args, **kw):
        return compare(torch, results, 3, *args, card, **kw)

    pix, dc_q = check(
        "nv21_pix_dc", "v2", lambda: bs_cuda.nv21_pix_dc(frames, W, H),
        lambda: bs_cuda.nv21_pix_dc_plain(frames, W, H),
        lambda out: rl.nv21_pix_dc_work(B, W, H))
    nv21_checks(torch, np, synth, card, frames)
    nb = pix.shape[2]

    for codec, label in ((bs_ops.BS_V2, "v2"), (bs_ops.BS_V3DC, "v3dc")):
        if codec == bs_ops.BS_V2:
            dc_bits, dc_code = bs_ops._dc_stage(dc_q, codec)
        else:
            dc_bits, dc_code = check_dc(torch, results, card, dc_q)
        thr = bs_ops.ac_threshold(
            budgets, dc_bits.sum(dim=1, dtype=torch.int32), nb)
        scale, _, _, coefs = check(
            "select_scale_pix", label,
            lambda: bs_cuda.select_scale_pix(pix, thr),
            lambda: bs_cuda.select_scale_pix_plain(pix, thr),
            select_work_of(torch, nb, True))
        if codec == bs_ops.BS_V2:
            select_pix_checks(torch, np, synth, card, results, pix, budgets,
                              dc_bits, thr, scale)
        sidx = torch.where(scale <= 63, scale, 1)
        eof = 0x1FF if codec == bs_ops.BS_V2 else 0x3FF
        vals32, e0, block_bits, _ = check(
            "emit_prep", label,
            lambda: bs_cuda.emit_prep(coefs, sidx, dc_code, dc_bits, eof=eof),
            lambda: bs_cuda.emit_prep_plain(coefs, sidx, dc_code, dc_bits,
                                            eof=eof),
            emit_work_of(rl.emit_prep_work, coefs, sidx, nb))
        if codec == bs_ops.BS_V2:
            emit_stats_line(torch, 3, coefs, (sidx, dc_code, dc_bits), eof,
                            card)
        lib_fn, lib_words = scatter_add_call(torch, vals32, e0)
        placed = check(
            "place_vals", label,
            lambda: bitpack_cuda.place_vals(vals32, e0,
                                            capacity_words=CAP_WORDS),
            lambda: bitpack_cuda.place_vals_plain(
                vals32, e0, capacity_words=CAP_WORDS), place_work_of(e0),
            library_fn=lib_fn, grid=bitpack_cuda.place_vals_grid(
                B, CAP_WORDS))
        if not torch.equal(lib_words, placed):
            raise AssertionError("one scatter_add_ on prepared indices "
                                 "differs from K4")
        gathered = compare(
            torch, {}, 3, "place_vals_gather", label,
            lambda: bitpack_cuda.place_vals_gather(
                vals32, e0, capacity_words=CAP_WORDS),
            lambda: bitpack_cuda.place_vals_gather_plain(
                vals32, e0, capacity_words=CAP_WORDS), place_work_of(e0), card,
            library_fn=lib_fn, grid=bitpack_cuda.place_vals_gather_grid(
                B, CAP_WORDS), ten=True)
        if not torch.equal(gathered, placed):
            raise AssertionError("K8 differs from K4 on phase 3's batch")
        if codec == bs_ops.BS_V2:
            place_cases(torch, np, synth, card, vals32, e0,
                        (pix, budgets, dc_bits, dc_code))
        if not check_tail(torch, results, 3, label, placed, coefs,
                          (sidx, dc_code, dc_bits), block_bits, eof, card):
            raise AssertionError("phase 3: no frame has a block over 256 "
                                 "bits")
    tail_cases(torch, np, synth, card, results)
    dc_checks(torch, np, synth, card, results["dc_stage"], dc_q)
    return results


def place_case(torch, card, label, vals32, e0, capacity_words):
    """K4 on one case == its plain version and one scatter_add_, exactly,
    timed by ``compare`` (one and ten calls a graph, an empty launch of its
    grid); prints its ranges, how many range starts fall inside a block's
    nine words and where the longest frame's last block starts against
    cap32. Returns that start less cap32."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_place_cases import boundaries_inside

    b, nbe = e0.shape
    cap32 = (capacity_words + 1) // 2
    kw = dict(capacity_words=capacity_words)
    lib_fn, lib_words = scatter_add_call(torch, vals32, e0, capacity_words)
    got = compare(torch, {}, 3, "place_vals", label,
                  lambda: bitpack_cuda.place_vals(vals32, e0, **kw),
                  lambda: bitpack_cuda.place_vals_plain(vals32, e0, **kw),
                  place_work_of(e0), card, library_fn=lib_fn,
                  grid=bitpack_cuda.place_vals_grid(b, capacity_words),
                  size=f"B={b}, NBe={nbe}, cap32={cap32}", ten=True)
    words = bitpack_cuda.place_range_words(
        b, capacity_words, bs_cuda.sm_count(e0.device))
    inside = boundaries_inside(e0.cpu().numpy(), cap32, words)
    past = int(e0[:, -1].max()) - cap32
    same = torch.equal(got, lib_words)
    say(f"[3] place_vals {label}: ranges of {words} words, "
        f"{-(-cap32 // words)} a frame; {inside} range starts fall inside "
        f"a block's nine words; the longest frame's last block starts "
        f"{abs(past)} words {'past' if past >= 0 else 'before'} cap32; "
        f"equal to one scatter_add_: {same}")
    if not same:
        raise AssertionError(f"place_vals {label}: K4 differs from one "
                             "scatter_add_")
    return past


def place_cases(torch, np, synth, card, vals32, e0, v2_inputs):
    """Phase 3, K4 beyond its row (phase 3's v2 batch): that batch's range
    starts inside blocks, and ``place_case`` on its first frame alone, on
    300 frames (its frames over again), on it with frame 5 unfittable (its
    words run past cap32), on 640x480 frames (frame 1 unfittable) and on
    16 frames of hand-made offsets that tie (tests/torch_place_cases.py).
    ``v2_inputs``: the batch's pixel rows, budgets, DC bits and codes."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_place_cases import boundaries_inside, tied_frames

    def prep(pix, thr, dc_bits, dc_code):
        scale, _, _, coefs = bs_cuda.select_scale_pix(pix, thr)
        sidx = torch.where(scale <= 63, scale, 1)
        return bs_cuda.emit_prep(coefs, sidx, dc_code, dc_bits,
                                 eof=0x1FF)[:2]

    pix, budgets, dc_bits, dc_code = v2_inputs
    b, nbe = e0.shape
    words = bitpack_cuda.place_range_words(b, CAP_WORDS,
                                           bs_cuda.sm_count(e0.device))
    if not boundaries_inside(e0.cpu().numpy(), (CAP_WORDS + 1) // 2, words):
        raise AssertionError("phase 3: no range start of K4 falls inside a "
                             "block")
    budgets_u = budgets.clone()
    budgets_u[UNFIT_FRAME] = UNFIT_BUDGET
    thr_u = bs_ops.ac_threshold(
        budgets_u, dc_bits.sum(dim=1, dtype=torch.int32), nbe - 1)
    pixb, thrb = big_frames(torch, np, synth)
    big_bits, big_code = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pixb),
                                          bs_ops.BS_V2)
    tv, te = tied_frames(16, nbe)
    te_max = int(te.max())
    cases = (
        ("one frame", vals32[:1], e0[:1], CAP_WORDS, False),
        ("300 frames", torch.cat([vals32] * 3)[:300].contiguous(),
         torch.cat([e0] * 3)[:300].contiguous(), CAP_WORDS, False),
        ("frame 5 unfittable", *prep(pix, thr_u, dc_bits, dc_code),
         CAP_WORDS, True),
        (f"{BIG_W}x{BIG_H}, frame 1 unfittable",
         *prep(pixb, thrb, big_bits, big_code), (4 * BUDGET - 7) // 2, True),
        ("16 frames of offsets that tie",
         torch.from_numpy(tv).to(e0.device), torch.from_numpy(te).to(
             e0.device), 2 * te_max + 20, False))
    for label, v, e, cap, unfit in cases:
        if place_case(torch, card, label, v, e, cap) <= 0 and unfit:
            raise AssertionError(f"place_vals {label}: no frame runs past "
                                 "cap32")


def tail_cases(torch, np, synth, card, results):
    """Phase 3, the tail emission beyond its rows: ``check_tail`` on noise
    frames (no block over 256 bits: every CTA leaves after reading its
    totals) and on tests/torch_emit_cases.py's edge_inputs at 320x240 (a
    block of exactly 256 bits, one of 257, an escape across bit 256, all 63
    levels clamped, runs over 31; frame 0 at scale 1 runs past the
    capacity, so its later tails drop whole)."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_emit_cases import edge_inputs, select_form

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.integers(
        0, 256, (B, W * H * 3 // 2)).astype(np.uint8)).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    pix, thr = select_inputs(torch, noise, budgets)
    dc_bits, dc_code = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                        bs_ops.BS_V2)
    scale, _, _, coefs = bs_cuda.select_scale_pix(pix, thr)
    c, sc, dcc, dcb = edge_inputs(pix.shape[2])
    edge = [torch.from_numpy(a).to(dev) for a in (select_form(c), sc, dcc,
                                                  dcb)]
    cases = (("noise", coefs, (torch.where(scale <= 63, scale, 1), dc_code,
                               dc_bits), 0),
             ("edge_inputs", edge[0], tuple(edge[1:]), 2))
    for label, c64, args, frames in cases:
        vals32, e0, block_bits, _ = bs_cuda.emit_prep(c64, *args, eof=0x1FF)
        placed = bitpack_cuda.place_vals(vals32, e0, capacity_words=CAP_WORDS)
        n = check_tail(torch, results, 3, label, placed, c64, args,
                       block_bits, 0x1FF, card,
                       size=f"B={block_bits.shape[0]}, {W}x{H}")
        if n != frames:
            raise AssertionError(f"emit_tail {label}: {n} frames with a "
                                 f"block over 256 bits, expected {frames}")


def nv21_checks(torch, np, synth, card, frames):
    """Phase 3, the NV21 kernel beyond its row: on the first 3 of the
    batch's ``frames`` (900 macroblocks, so the last CTA's run is short)
    and on BIG_FRAMES frames of BIG_W x BIG_H, equal to its plain version
    and timed."""
    from psxavenc_tpu_torch.ops import bs_cuda

    big = torch.from_numpy(np.stack([nv21(np, p, BIG_W, BIG_H) for p in
                                     synth.rand_frames(BIG_W, BIG_H,
                                                       BIG_FRAMES, seed=17)]))
    for f, w, h in ((frames[:3], W, H), (big.to(frames.device), BIG_W, BIG_H)):
        err = max_abs_err(torch, bs_cuda.nv21_pix_dc(f, w, h),
                          bs_cuda.nv21_pix_dc_plain(f, w, h), "nv21_pix_dc")
        ms = graph_ms(torch, lambda: bs_cuda.nv21_pix_dc(f, w, h))
        bound_ms, by = rl.bound(*rl.nv21_pix_dc_work(f.shape[0], w, h))
        say(f"[3] nv21_pix_dc on {f.shape[0]} frames {w}x{h}: max |kernel - "
            f"plain| = {err}; kernel {ms:.4f} ms on the device (graph "
            f"replay), bound {bound_ms:.4f} ms ({by}) on {card}")
        if err:
            raise AssertionError(f"nv21_pix_dc on {w}x{h}: kernel disagrees "
                                 "with its plain version")


def check_dc(torch, results, card, dc_q):
    """Phase 3: K2 on v3dc == its plain version on the DCs ``dc_q``; its
    row goes into ``results``."""
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    return compare(torch, results, 3, "dc_stage", "v3dc",
                   lambda: bs_cuda.dc_stage(dc_q, bs_ops.BS_V3DC),
                   lambda: bs_cuda.dc_stage_plain(dc_q, bs_ops.BS_V3DC),
                   lambda out: rl.dc_work(*dc_q.shape), card)


def dc_checks(torch, np, synth, card, row, dc_q):
    """Phase 3, K2 beyond its row (v3dc on the batch's DCs): both codecs
    on the same DCs, on them made all ties (every DC 2 mod 4, so each step
    of a chain depends on the one before) and on 640x480 frames, each equal
    to its plain version and timed; and the floor of a launch, an empty
    kernel of one CTA and of K2's grid, which goes into K2's ``row``."""
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    pixb, _ = big_frames(torch, np, synth)
    cases = (("320x240", dc_q), ("320x240 all ties", (dc_q & ~3) | 2),
             (f"{BIG_W}x{BIG_H}", bs_ops.dc_quant_from_pixrows(pixb)))
    for label, dc in cases:
        for codec, name in ((bs_ops.BS_V3, "v3"), (bs_ops.BS_V3DC, "v3dc")):
            err = max_abs_err(torch, bs_cuda.dc_stage(dc, codec),
                              bs_cuda.dc_stage_plain(dc, codec), "dc_stage")
            ms = graph_ms(torch, lambda: bs_cuda.dc_stage(dc, codec))
            say(f"[3] dc_stage {label} {name}, {dc.shape[0]} frames of "
                f"{dc.shape[1]} blocks: max |kernel - plain| = {err}; kernel "
                f"{ms:.4f} ms on the device (graph replay) on {card}")
            if err:
                raise AssertionError(f"dc_stage {label} {name}: kernel "
                                     "disagrees with its plain version")
    grid = (dc_q.shape[0], bs_cuda.DC_PARTS * 32)
    row["floor_ms"] = graph_ms(torch, lambda: bs_cuda.empty_launch(dc_q))
    row["floor_grid_ms"] = graph_ms(
        torch, lambda: bs_cuda.empty_launch(dc_q, *grid))
    ten = [graph_ms(torch, fn, calls=10) for fn in (
        lambda: bs_cuda.dc_stage(dc_q, bs_ops.BS_V3DC),
        lambda: bs_cuda.empty_launch(dc_q, *grid))]
    say(f"[3] dc_stage {row['ms']:.4f} ms (B={B}, {W}x{H}, v3dc; the target "
        f"is 0.010); the floor of a launch: an empty kernel of 1 CTA "
        f"{row['floor_ms']:.4f} ms, of K2's grid ({grid[0]} CTAs of "
        f"{grid[1]} threads) {row['floor_grid_ms']:.4f} ms; K2 is "
        f"{row['ms'] - row['floor_grid_ms']:.4f} ms above the latter; ten "
        f"calls a graph: K2 {ten[0]:.4f} ms a call, the empty kernel of "
        f"K2's grid {ten[1]:.4f}, on {card}")


def bound_evals(torch, scale):
    """Evaluations per frame that the bound counts (see select_work)."""
    return float(torch.where((scale > 1) & (scale <= 63), 2, 1).to(
        torch.float64).mean())


def select_pix_checks(torch, np, synth, card, results, pix, budgets, dc_bits,
                      thr, scale):
    """Phase 3, K1's search: the seed cases with one frame unfittable,
    the seeded times on the row's own thresholds, frames whose subsample
    misleads, and 640x480 frames."""
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    name = "select_scale_pix"
    nb = pix.shape[2]
    budgets_u = budgets.clone()
    budgets_u[UNFIT_FRAME] = UNFIT_BUDGET
    thr_u = bs_ops.ac_threshold(
        budgets_u, dc_bits.sum(dim=1, dtype=torch.int32), nb)
    want = bs_cuda.select_scale_pix_plain(pix, thr_u)
    if int(want[0][UNFIT_FRAME]) != 64:
        raise AssertionError("phase 3: the unfittable frame fits")
    c_abs = want[3][:, :63, :nb].to(torch.int32).abs()
    check_seed_cases(torch, 3, name,
                     lambda seeds, stats: bs_cuda.select_scale_pix(
                         pix, thr_u, seeds, stats_out=stats),
                     want, c_abs, thr_u, bs_cuda.K1_THREADS, card)
    lane_balance(torch, 3, c_abs, scale)

    def kernel(seeds, stats):
        return bs_cuda.select_scale_pix(pix, thr, seeds, stats_out=stats)

    stats = torch.zeros((pix.shape[0], len(bs_cuda.STAT_NAMES)),
                        dtype=torch.int32, device=pix.device)
    kernel(None, stats)
    seeded_times(torch, 3, name, results[name], kernel, (scale,), stats,
                 bound_evals(torch, scale),
                 bs_cuda.search_groups(nb, bs_cuda.K1_THREADS), card)
    check_misleading(torch, 3, name, pix, bs_cuda.K1_THREADS,
                     lambda p, c, t, seeds, st: bs_cuda.select_scale_pix(
                         p, t, seeds, stats_out=st), card)

    pixb, thrb = big_frames(torch, np, synth)
    check_big(torch, 3, name,
              lambda seeds, st: bs_cuda.select_scale_pix(pixb, thrb, seeds,
                                                         stats_out=st),
              lambda: bs_cuda.select_scale_pix_plain(pixb, thrb), pixb, thrb,
              card)


def scatter_add_call(torch, vals32, e0, capacity_words=CAP_WORDS):
    """One scatter_add_ computes K4's, K8's and K9's placement from the
    placed u32 words (int32 bit patterns) and their prepared, clipped
    indices (a spare column takes the dropped words): the words are
    bit-disjoint, so add == or. Returns (the call, for timing; the (B,
    cap32) words of one call on a zeroed output)."""
    cap32 = (capacity_words + 1) // 2
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
        if enc.tier != "device":
            raise AssertionError(f"phase 4: the encoder's tier is {enc.tier}")
        got = enc.encode_frames(list(frames), budgets)
        digest = sha256(b"".join(buf.tobytes() for buf, _ in got))
        if digest != digests[f"phase4_{label}"]:
            raise AssertionError(f"{label}: {MAIN_FRAMES} frames differ "
                                 "from the JAX package's digest")
        say(f"[4] {label}: {MAIN_FRAMES} frames {W}x{H} equal the JAX "
            f"package's digest; mean quant scale "
            f"{enc.quant_scale_sum / MAIN_FRAMES:.2f}")
    launches = dict(bs_cuda.LAUNCHES, **bitpack_cuda.LAUNCHES)
    say(f"[4] launches in the video path: {launches}; frames with a block "
        f"over 256 bits (counted on the device by the tail emission): "
        f"{api.COUNTERS['overflow_frames']} of {3 * MAIN_FRAMES}")
    for name in ("nv21_pix_dc", "select_scale_pix", "dc_stage",
                 "emit_prep", "place_vals", "emit_tail"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "video path")
    return launches


def file_digest(path):
    with open(path, "rb") as f:
        return sha256(f.read())


# The CLI as ``python -m psxavenc_tpu_torch.cli`` runs it, followed by a
# last line of the native library's call counts in that process.
CLI_RUNNER = """
import json, sys
from psxavenc_tpu_torch import cli
from psxavenc_tpu_torch.native import tiers
rc = cli.main(sys.argv[1:])
print(json.dumps(tiers.COUNTERS))
sys.exit(rc)
"""


def cli_phase(digests, tmp):
    """Phase 5: the port's video CLI as a user runs it."""

    def run(argv, out, platform):
        # "cpu": the kernels' plain versions; "cpu-native": the native C++
        # tiers (what PSXAVENC_PLATFORM=cpu takes by default), with no
        # tier variable inherited from the caller.
        env = dict(os.environ, PSXAVENC_PLATFORM=platform.split("-")[0])
        env.pop("PSXAVENC_VIDEO_TIER", None)
        env.pop("PSXAVENC_NO_NATIVE_ADPCM", None)
        if platform == "cpu":
            env.update(PSXAVENC_VIDEO_TIER="device",
                       PSXAVENC_NO_NATIVE_ADPCM="1")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_RUNNER, "-q", *argv,
             os.path.join(tmp, "in.avi"), out],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"cli {argv} ({platform}) exited "
                                 f"{proc.returncode}: {proc.stderr}")
        calls = json.loads(proc.stdout.strip().splitlines()[-1])
        if (calls["bs_encode_frames"] > 0) != (platform == "cpu-native") \
                or (platform != "cpu-native" and any(calls.values())):
            raise AssertionError(f"cli {argv} ({platform}): native calls "
                                 f"{calls}")
        return time.time() - t0, calls

    for key, argv, _ in VIDEO_CLI_CASES:
        for platform in (("cuda", "cpu", "cpu-native") if key == "cli_strv"
                         else ("cuda",)):
            out = os.path.join(tmp, platform, out_name(key))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            secs, calls = run(argv, out, platform)
            if file_digest(out) != digests[key]:
                raise AssertionError(f"cli {' '.join(argv)} on {platform} "
                                     "differs from the JAX package")
            say(f"[5] cli {' '.join(argv)} on {platform}: {CLI_FRAMES} "
                f"frames equal the JAX package's digest ({secs:.1f} s incl. "
                f"start-up; native library calls {calls})")


# Operations that make the host wait for a device value.
HOST_WAITS = ("aten::nonzero", "aten::item", "aten::_local_scalar_dense",
              "aten::is_nonzero")


def profile_step(torch, step, label, card, out_dir, reps=5):
    """The step's device operations over ``reps`` steps (torch.profiler;
    the table goes to <out_dir>/profile_<label>.txt): it must hold no
    operation of HOST_WAITS. The profiler's device times are not used:
    late in this long process they read about 0.6 of the truth."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(rows.table(sort_by="count", row_limit=60))
    waits = sorted(e.key for e in rows if e.key in HOST_WAITS)
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    say(f"[6] profile {label}: {sum(e.count for e in kernels) / reps:.0f} "
        f"device operations a step, of {len(kernels)} kinds; operations "
        f"that wait for the device ({', '.join(HOST_WAITS)}): "
        f"{waits or 'none'} (on {card})")
    if waits:
        raise AssertionError(f"the {label} device step waits for the "
                             f"device in {waits}")


def busy_share(torch, step, label, step_ms, card):
    """The device step's busy share: each hand-written kernel that one call
    of ``step`` launches (the stages of api._KERNELS, recorded as they are
    called) timed by graph_ms on the step's own inputs, summed, and the
    whole step timed by graph_ms (kernels and glue with no host between
    them), each over ``step_ms``, the step's CUDA-event time."""
    from psxavenc_tpu_torch import api

    stages = api._KERNELS
    saved = dict(vars(stages))
    calls = []

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, fn, args, kw))
            return out
        return call

    for name, fn in saved.items():
        setattr(stages, name, recorder(name, fn))
    try:
        step()
    finally:
        for name, fn in saved.items():
            setattr(stages, name, fn)
    times = {}
    for name, fn, args, kw in calls:
        if name == "emit_tail":     # ORs into its first argument, counts
            args = (args[0].clone(),) + args[1:]
            kw = dict(kw, count=torch.zeros_like(kw["count"]))
        times[name] = times.get(name, 0.0) + graph_ms(
            torch, lambda: fn(*args, **kw))
    kernels_ms = sum(times.values())
    whole_ms = graph_ms(torch, step)
    say(f"[6] {label} busy share of the {step_ms:.4f} ms step (CUDA events): "
        f"its hand-written kernels {kernels_ms:.4f} ms = "
        f"{100 * kernels_ms / step_ms:.1f}% ("
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; each call timed in a CUDA graph); the whole step in one CUDA "
        f"graph {whole_ms:.4f} ms = "
        f"{100 * whole_ms / step_ms:.1f}% (kernels and glue, no host between "
        f"them) on {card}")


STEP_REPEATS = 7


def throughput(torch, np, synth, card, out_dir):
    """Phase 6: BS v2 320x240 frames/s at B=128, on synthetic video, on
    the same with every eighth frame noise (both have frames with blocks
    over 256 bits) and on noise frames alone (none has: at 18,144 bytes
    noise lands on high scales)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    from psxavenc_tpu_torch.ops import bs_cuda

    dev = torch.device("cuda", 0)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    mixes = (
        ("video", smoke_frames(np, synth, B, seed=14, noise_every=0)),
        ("video+noise", smoke_frames(np, synth, B, seed=14, noise_every=8)),
        ("noise", rng.integers(0, 256, (B, W * H * 3 // 2)).astype(np.uint8)),
    )
    for label, host in mixes:
        frames = torch.from_numpy(host).to(dev)

        def step(use_kernels=True):
            return api.bs_encode_frames_packed(
                frames, budgets, codec=0, width=W, height=H,
                capacity_words=CAP_WORDS, use_kernels=use_kernels)

        api.COUNTERS["overflow_frames"] = 0
        tails = bs_cuda.LAUNCHES["emit_tail"]
        step()
        tails = bs_cuda.LAUNCHES["emit_tail"] - tails
        overflow = api.COUNTERS["overflow_frames"]
        if tails != 1 or (overflow > 0) != (label != "noise"):
            raise AssertionError(
                f"phase 6, {label}: {tails} launches of the tail emission "
                f"in a step, {overflow} frames with a block over 256 bits")
        runs = sorted(time_ms(torch, step, reps=10)
                      for _ in range(STEP_REPEATS))
        ms = statistics.median(runs)
        say(f"[6] {label} device: {B / ms * 1000:.1f} frames/s ({ms:.4f} ms "
            f"per {B}-frame batch, the median of {STEP_REPEATS} medians of 10 "
            f"steps, least {runs[0]:.4f}, greatest {runs[-1]:.4f}; kernels + "
            f"glue, no H2D; {overflow} of {B} frames have a block over 256 "
            f"bits, counted on the device) on {card}")
        busy_share(torch, step, label, ms, card)
        profile_step(torch, step, label.replace("+", "_"), card, out_dir)
        if label == "video+noise":
            # A stream route: K7, K9 and the tail emission.
            profile_step(torch, lambda: api.bs_encode_frames_packed(
                frames, budgets, codec=0, width=W, height=H,
                capacity_words=CAP_WORDS, packer="fused_pallas"),
                "video_noise_fused_pallas", card, out_dir)
        plain_ms = time_ms(torch, lambda: step(False), reps=3)
        say(f"[6] {label} plain path on the card: "
            f"{B / plain_ms * 1000:.1f} frames/s ({plain_ms:.4f} ms per "
            f"batch) on {card}")

        ms_e2e = end_to_end(torch, np, synth, label, card)
        density = rl.nonzero_share(*density_inputs(torch, frames, budgets))
        chip = rl.chip_for(torch.cuda.get_device_name(0))
        sol_ms, pct = rl.video_report(ms, chip, W, H, B, CAP_WORDS, 0,
                                      density)
        say(f"[6] {label} speed of light (utils/roofline.py: K1, K3, K4 and "
            f"the tail emission at this mix's nonzero density "
            f"{density:.4f}): {sol_ms:.4f} ms per {B}-frame batch; the "
            f"device step reaches {pct:.1f}% of it, end to end (pipelined) "
            f"{100 * sol_ms / ms_e2e:.1f}% on {card}")
        if label != "noise":
            carried_seed_hits(torch, label, frames, budgets, 8, card)


E2E_BATCHES = 8
E2E_PAIRS = 5


def e2e_frames(np, synth, label):
    """E2E_BATCHES different B-frame batches of phase 6's mix ``label``."""
    n = E2E_BATCHES * B
    if label == "noise":
        rng = np.random.default_rng(31)
        return rng.integers(0, 256, (n, W * H * 3 // 2)).astype(np.uint8)
    return smoke_frames(np, synth, n, seed=15,
                        noise_every=8 if label == "video+noise" else 0)


def end_to_end(torch, np, synth, label, card):
    """Phase 6, end to end: BsFrameEncoder on E2E_BATCHES different
    batches, host frames to frame buffers (H2D, device, D2H, headers),
    pipelined (encode_frames) and one batch at a time (each batch fetched
    before the next is launched), in E2E_PAIRS interleaved pairs; both
    give the same bytes, quant-scale sums and overflow counts. Returns the
    pipelined median ms per batch."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    frames = list(e2e_frames(np, synth, label))
    budgets = [BUDGET] * len(frames)

    def pipelined(enc):
        return enc.encode_frames(frames, budgets)

    def one_at_a_time(enc):
        out = []
        for base in range(0, len(frames), B):
            out += enc.fetch(enc.encode_frames_async(
                frames[base:base + B], budgets[base:base + B]))
        return out

    runs = {"pipelined": pipelined, "one batch at a time": one_at_a_time}
    encoders = {mode: BsFrameEncoder(0, W, H, "cuda") for mode in runs}
    if any(enc.tier != "device" for enc in encoders.values()):
        raise AssertionError("phase 6: an encoder's tier is not the card's")
    times = {mode: [] for mode in runs}
    seen = {}
    for mode, fn in runs.items():                       # warm-up
        fn(encoders[mode])
    for i in range(E2E_PAIRS):
        for mode in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            enc = encoders[mode]
            scales = enc.quant_scale_sum
            api.COUNTERS["overflow_frames"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = runs[mode](enc)
            times[mode].append(time.perf_counter() - t0)
            outcome = (sha256(b"".join(buf.tobytes() for buf, _ in got)),
                       enc.quant_scale_sum - scales,
                       api.COUNTERS["overflow_frames"])
            if seen.setdefault(mode, outcome) != outcome:
                raise AssertionError(f"phase 6, {label}: {mode} runs differ")
    if seen["pipelined"] != seen["one batch at a time"]:
        raise AssertionError(f"phase 6, {label}: the pipelined encoder "
                             "differs from one batch at a time")
    n = len(frames)
    text = []
    for mode, ts in times.items():
        ts = sorted(ts)
        text.append(f"{mode} {n / statistics.median(ts):.1f} frames/s "
                    f"(least {n / ts[-1]:.1f}, greatest {n / ts[0]:.1f})")
    say(f"[6] {label} end to end, {n} frames in {E2E_BATCHES} different "
        f"{B}-frame batches (host frames to frame buffers: H2D, device, D2H, "
        f"headers), median of {E2E_PAIRS} interleaved pairs: "
        + "; ".join(text)
        + f"; equal bytes, quant-scale sums ({seen['pipelined'][1]}) and "
        f"frames with a block over 256 bits ({seen['pipelined'][2]}) on "
        f"{card}")
    return statistics.median(times["pipelined"]) * 1e3 / E2E_BATCHES


def density_inputs(torch, frames, budgets):
    """(coefficients, scale, NB) of a step on ``frames`` (BS v2), for the
    speed of light's nonzero density."""
    from psxavenc_tpu_torch import api

    sel = api._select_pixels(frames, budgets, 0, W, H, api._KERNELS)
    return sel["c"], sel["scale_idx"] + 1, sel["dc_code"].shape[1]


def carried_seed_hits(torch, label, frames, budgets, n_batches, card):
    """Phase 6: K1's statistics over ``n_batches`` batches of ``frames``
    seeded as an encoder could carry seeds: the first batch not at all,
    each later frame with the scale of the last frame of the batch before.
    BsFrameEncoder does not do so; this says what it would buy."""
    from psxavenc_tpu_torch.ops import bs_cuda

    pix, thr = select_inputs(torch, frames, budgets)
    rows = []
    seed = None
    for _ in range(n_batches):
        stats = torch.zeros((frames.shape[0], len(bs_cuda.STAT_NAMES)),
                            dtype=torch.int32, device=frames.device)
        seeds = None if seed is None else seed.expand(
            frames.shape[0]).contiguous()
        scale = bs_cuda.select_scale_pix(pix, thr, seeds, stats_out=stats)[0]
        seed = scale[-1:].clamp(max=63)
        if seeds is not None:
            rows.append(stats)
    seeded = torch.cat(rows)
    torch.cuda.synchronize()
    say(f"[6] {label} K1 with seeds carried from batch to batch (the "
        f"encoder carries none) over the {n_batches - 1} seeded batches "
        f"of {frames.shape[0]} frames (seed {int(seed)}; scales "
        f"{int(scale.min())}..{int(scale.max())}): "
        f"{stats_text(torch, seeded)} (on {card})")


def adpcm_kernel(torch, np, synth, card):
    """Phase 7: K5 == its plain version for the three variants at 4,096
    streams x 64 units, on the plan's route (serial) and with
    ADPCM_FORCED_SEGMENTS segments a stream. Returns (the inputs on the card, the (5, 12)
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
        forced = adpcm_cuda.encode_units(*head, filter_count=fc,
                                         shift_range=sr,
                                         segments=ADPCM_FORCED_SEGMENTS)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want, "adpcm_encode_units")
        forced_err = max_abs_err(torch, forced, want, "adpcm_encode_units")
        ms = graph_ms(torch, kernel_fn)
        call_ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn, reps=1)
        bound_ms, bound_by = rl.bound(*rl.adpcm_work(
            ADPCM_STREAMS, ADPCM_CHECK_UNITS, fc, got[1].shape[2]))
        say(f"[7] adpcm_encode_units ({fc}, {sr}): headers, words, s1, s2 "
            f"max |kernel - plain| = {err}; kernel {ms:.4f} ms on the device "
            f"(graph replay; one wrapper call {call_ms:.4f} ms with its host "
            f"work), "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"({ADPCM_STREAMS} streams x {ADPCM_CHECK_UNITS} units, the "
            f"plan's {adpcm_cuda.plan_segments(*head[1].shape)} segment a "
            f"stream; with {ADPCM_FORCED_SEGMENTS} forced: max |kernel - "
            f"plain| = {forced_err}) on {card}")
        if err or forced_err:
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
    if adpcm_cuda.plan_segments(ADPCM_STREAMS, ADPCM_UNITS) != 1:
        raise AssertionError("the plan cuts the batch's streams")
    ms = time_ms(torch, lambda: adpcm_cuda.encode_units(
        *full, filter_count=5, shift_range=12), reps=5)
    plan_graph = graph_ms(torch, lambda: adpcm_cuda.encode_units(
        *full, filter_count=5, shift_range=12), reps=10)
    serial_graph = graph_ms(torch, lambda: adpcm_cuda.encode_units(
        *full, filter_count=5, shift_range=12, segments=1), reps=10)
    out = adpcm_cuda.encode_units(*full, filter_count=5, shift_range=12)
    n_units = ADPCM_STREAMS * ADPCM_UNITS
    bound_ms, bound_by = rl.bound(*rl.adpcm_work(
        ADPCM_STREAMS, ADPCM_UNITS, 5, out[1].shape[2]))
    api_ms = time_ms(torch, lambda: api.spu_encode_batch(*full), reps=3)
    say(f"[8] spu_encode_batch {ADPCM_STREAMS} x {ADPCM_UNITS} units "
        f"({n_units * 28 / 1e6:.1f} M samples, "
        f"{full[0].numel() * 4 / 1e6:.0f} MB of int32 units on the card): "
        f"first {n} units equal the checked kernel run; K5 {ms:.3f} ms = "
        f"{n_units * 28 / ms / 1e3:.1f} Msamples/s on the device, bound "
        f"{bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of the "
        f"bound; whole API call {api_ms:.3f} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; in a CUDA graph the plan's route (1 "
        f"segment a stream) {plan_graph:.4f} ms, segments=1 "
        f"{serial_graph:.4f} ms ({plan_graph / serial_graph:.4f}x); on "
        f"{card}")
    msps = n_units * 28 / ms / 1e3
    sol_msps, pct = rl.audio_report(
        msps, rl.chip_for(torch.cuda.get_device_name(0)))
    say(f"[8] K5 speed of light (utils/roofline.py, "
        f"{rl.audio_kernel_census():.0f} int32 operations a sample): "
        f"{sol_msps:.1f} Msamples/s = {n_units * 28 / sol_msps / 1e3:.3f} ms "
        f"for this batch; K5 reaches {pct:.1f}% of it on {card}")
    return {"batch_ms": plan_graph, "batch_serial_ms": serial_graph}


def adpcm_tracks(torch, np, synth, card):
    """Phase 8: K5 on one long file, a 60 s stereo 37,800 Hz XA track's two
    streams of XA_TRACK_UNITS units (4-bit XA), synthetic audio and the
    440 Hz tone: the plan's segments equal the native unit encoder and the
    plain model of the scheme (encode_units_segmented_plain over the native
    tier), the kernels' stats equal the model's count for count; both
    routes timed in a CUDA graph, the plan's and segments=1, beside the
    native tier's host time. Returns the K5 row's track keys."""
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.ops import adpcm_cuda

    dev = torch.device("cuda", 0)
    tiers.lib()                              # built before it is timed
    paths_calls = dict(tiers.COUNTERS)       # the references are no path's
    row = {}
    for label, what, host in (
            ("track", "synthetic audio", xa_track_units(np, synth)),
            ("tone", "a 440 Hz tone at 30,000", tone_track_units(np, synth))):
        args = [torch.from_numpy(a).to(dev) for a in host]
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        out = adpcm_cuda.encode_units(*args, filter_count=4, shift_range=12,
                                      stats_out=stats)
        got = (out[0], adpcm_cuda.unpack_words(out[1], 12), *out[2:])
        t0 = time.perf_counter()
        want = tiers.adpcm_encode_units(*host, 4, 12)
        native_ms = (time.perf_counter() - t0) * 1e3
        *model, model_stats = adpcm_cuda.encode_units_segmented_plain(
            *(torch.from_numpy(a) for a in host), filter_count=4,
            shift_range=12, rows="native")
        model = (model[0], adpcm_cuda.unpack_words(model[1], 12), *model[2:])
        err = max(max_abs_err(torch, g, torch.from_numpy(
            np.asarray(w, np.int32)).to(dev), "adpcm_encode_units")
            for g, w in zip(got, want))
        err = max(err, max_abs_err(torch, got, tuple(m.to(dev)
                                                    for m in model),
                                   "adpcm_encode_units"))
        stats, model_stats = stats.tolist(), model_stats.tolist()
        if err or stats != model_stats:
            raise AssertionError(f"K5 on the {label}: max |kernel - native| "
                                 f"= {err}, stats {stats} against the "
                                 f"model's {model_stats}")
        ms = graph_ms(torch, lambda: adpcm_cuda.encode_units(
            *args, filter_count=4, shift_range=12), reps=5)
        serial_ms = graph_ms(torch, lambda: adpcm_cuda.encode_units(
            *args, filter_count=4, shift_range=12, segments=1), reps=3)
        B, T = host[1].shape
        bound_ms, bound_by = rl.bound(*rl.adpcm_work(B, T, 4,
                                                     out[1].shape[2]))
        names = dict(zip(adpcm_cuda.STAT_NAMES, stats))
        say(f"[8] adpcm_encode_units (4, 12) on a 60 s stereo XA track of "
            f"{what} ({B} x {T} units, {adpcm_cuda.plan_segments(B, T)} segments a "
            f"stream): equal to the native tier and to the scheme's plain "
            f"model, stats {names} equal the model's; in a CUDA graph "
            f"{ms:.4f} ms, segments=1 {serial_ms:.4f} ms "
            f"({ms / serial_ms:.4f}x, {serial_ms / ms:.1f} times faster); "
            f"bound {bound_ms:.4f} ms ({bound_by}); the native tier "
            f"{native_ms:.1f} ms on the host ({os.cpu_count()} cores); on "
            f"{card}")
        row.update({f"{label}_ms": ms, f"{label}_serial_ms": serial_ms,
                    f"{label}_bound_ms": bound_ms,
                    f"{label}_native_ms": native_ms,
                    f"{label}_stats": names})
    # The CLI's chunk route: K5 reads the same kind of track straight from
    # its int16 PCM by XaAudioSectors' offsets (the index clamp on), held
    # to the native tier and the scheme's model on the units gathered on
    # the host, and counted as the offsets layout.
    pcm, offs, lim = xa_chunk_layout(np, synth)
    B, T = lim.shape
    zero = np.zeros(B, np.int32)
    units = adpcm_cuda.gather_units_plain(torch.from_numpy(pcm),
                                          torch.from_numpy(offs), T)
    host = (units.numpy(), lim, zero, zero)
    want = tiers.adpcm_encode_units(*host, 4, 12)
    *model, model_stats = adpcm_cuda.encode_units_segmented_plain(
        *(torch.from_numpy(a) for a in host), filter_count=4,
        shift_range=12, rows="native")
    model = (model[0], adpcm_cuda.unpack_words(model[1], 12), *model[2:])
    args = [torch.from_numpy(a).to(dev) for a in (pcm, offs, lim, zero,
                                                   zero)]
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    inputs = dict(adpcm_cuda.INPUTS)
    out = adpcm_cuda.encode_pcm_units(*args, filter_count=4, shift_range=12,
                                      stats_out=stats)
    if adpcm_cuda.INPUTS != {"offsets": inputs["offsets"] + 1,
                             "dense": inputs["dense"],
                             "shared_row": inputs["shared_row"]}:
        raise AssertionError(f"K5's chunk call counted as {adpcm_cuda.INPUTS}"
                             f" after {inputs}")
    got = (out[0], adpcm_cuda.unpack_words(out[1], 12), *out[2:])
    err = max(max_abs_err(torch, g, torch.from_numpy(
        np.asarray(w, np.int32)).to(dev), "adpcm_encode_pcm_units")
        for g, w in zip(got, want))
    err = max(err, max_abs_err(torch, got, tuple(m.to(dev) for m in model),
                               "adpcm_encode_pcm_units"))
    stats, model_stats = stats.tolist(), model_stats.tolist()
    if err or stats != model_stats:
        raise AssertionError(f"K5 on the track's chunk offsets: max |kernel "
                             f"- native| = {err}, stats {stats} against the "
                             f"model's {model_stats}")
    ms = graph_ms(torch, lambda: adpcm_cuda.encode_pcm_units(
        *args, filter_count=4, shift_range=12), reps=5)
    say(f"[8] adpcm_encode_pcm_units (4, 12) on the track's int16 PCM by "
        f"the XA CLI's chunk offsets ({B} x {T} units, {pcm.shape[1]} "
        f"samples a stream, offsets off the 28-grid, the tail past the "
        f"end): equal to the native tier and to the scheme's plain model on "
        f"the host's gather, stats {dict(zip(adpcm_cuda.STAT_NAMES, stats))}"
        f" equal the model's, counted as the offsets layout; in a CUDA graph"
        f" {ms:.4f} ms; on {card}")
    row["chunk_ms"] = ms
    tiers.COUNTERS.update(paths_calls)
    return row


def adpcm_shared_rows(torch, np, synth, card):
    """Phase 8: K5 on the shared row (``shared_row_clips`` at
    SHARED_ROW_LISTS' lengths, ``shared_row_xa``): the plan's route and
    ADPCM_FORCED_SEGMENTS segments equal the native unit encoder on the
    units gathered on the host and the plain version on the first
    ADPCM_CHECK_UNITS units; each call counts one "shared_row" input and
    its route's launches; the plan's route timed in a CUDA graph beside
    the dense layout on the same streams zero-padded (equal to it too).
    Returns the K5 row's shared-row keys."""
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.ops import adpcm_cuda

    dev = torch.device("cuda", 0)
    paths_calls = dict(tiers.COUNTERS)       # the references are no path's
    cases = [(label, f"{clips} mono clips of {lo}-{hi} s ({spacing})", 5,
              shared_row_clips(np, synth, clip_lengths(
                  np, clips, lo, hi, spacing), seed=101 + i))
             for i, (label, clips, lo, hi, spacing)
             in enumerate(SHARED_ROW_LISTS)]
    cases.append(("xa", "the XA track's two channels by their chunk "
                  "offsets", 4, shared_row_xa(np, synth)))
    row = {}
    for label, what, fc, (pcm, offs, lim, base, lengths, p1, p2) in cases:
        B, T = lim.shape
        base, lengths = adpcm_cuda.shared_row(base, lengths, len(pcm))
        units = adpcm_cuda.gather_units_plain(
            torch.from_numpy(pcm), None if offs is None
            else torch.from_numpy(offs), T, base=base, lengths=lengths)
        want = tuple(torch.from_numpy(np.asarray(w, np.int32)).to(dev)
                     for w in tiers.adpcm_encode_units(units.numpy(), lim, p1,
                                                       p2, fc, 12))
        n = ADPCM_CHECK_UNITS
        head = adpcm_cuda.encode_units_plain(
            units[:, :n], torch.from_numpy(lim[:, :n]), torch.from_numpy(p1),
            torch.from_numpy(p2), filter_count=fc, shift_range=12)
        head = tuple(t.to(dev) for t in (head[0], adpcm_cuda.unpack_words(
            head[1], 12), *head[2:]))
        args = [None if a is None else torch.from_numpy(a).to(dev)
                for a in (pcm, offs, lim, p1, p2)]
        base_d, lengths_d = (torch.from_numpy(a).to(dev)
                             for a in (base, lengths))

        def k5(segments=None):
            return adpcm_cuda.encode_pcm_units(
                *args, filter_count=fc, shift_range=12, segments=segments,
                base=base_d, lengths=lengths_d)

        S = adpcm_cuda.plan_segments(B, T)
        errs = {}
        for segments in (None, ADPCM_FORCED_SEGMENTS):
            inputs = dict(adpcm_cuda.INPUTS)
            launches = adpcm_cuda.LAUNCHES["adpcm_encode_units"]
            out = k5(segments)
            route = S if segments is None else segments
            if adpcm_cuda.INPUTS != dict(
                    inputs, shared_row=inputs["shared_row"] + 1) or \
                    adpcm_cuda.LAUNCHES["adpcm_encode_units"] - launches \
                    != (1 if route == 1 else 2 + adpcm_cuda.ROUNDS):
                raise AssertionError(
                    f"K5's shared row ({label}, {route} segments) counted as "
                    f"{adpcm_cuda.INPUTS}, launches {launches} -> "
                    f"{adpcm_cuda.LAUNCHES}")
            got = (out[0], adpcm_cuda.unpack_words(out[1], 12), *out[2:])
            errs[route] = max(
                max_abs_err(torch, got, want, "adpcm_encode_pcm_units"),
                max_abs_err(torch, tuple(g[:, :n] for g in got), head,
                            "adpcm_encode_pcm_units"))
        if any(errs.values()):
            raise AssertionError(f"K5 on the shared row ({label}): max "
                                 f"|kernel - reference| by route {errs}")
        ms = graph_ms(torch, k5, reps=5)
        bound_ms, bound_by = rl.bound(*rl.adpcm_work(B, T, fc,
                                                     out[1].shape[2]))
        dense = units.to(torch.int16).to(dev)
        dense_out = adpcm_cuda.encode_units(dense, *args[2:],
                                            filter_count=fc, shift_range=12)
        dense_err = max_abs_err(torch, dense_out, out,
                                "adpcm_encode_units")
        if dense_err:
            raise AssertionError(f"K5 on the shared row ({label}) differs "
                                 f"from the dense layout by {dense_err}")
        dense_ms = graph_ms(torch, lambda: adpcm_cuda.encode_units(
            dense, *args[2:], filter_count=fc, shift_range=12), reps=5)
        del dense, dense_out
        say(f"[8] adpcm_encode_pcm_units ({fc}, 12) on a shared row of "
            f"{what} ({B} streams x {T} units, {len(pcm)} samples, an empty "
            f"stream; the plan's {S} segments a stream and "
            f"{ADPCM_FORCED_SEGMENTS} forced): equal to the native tier and "
            f"to the plain version on the first {n} units, one shared_row "
            f"input and the route's launches a call; in a CUDA graph "
            f"{ms:.4f} ms, the dense layout on the same streams zero-padded "
            f"{dense_ms:.4f} ms ({ms / dense_ms:.4f}x), bound "
            f"{bound_ms:.4f} ms ({bound_by}); on {card}")
        row.update({f"{label}_shared_ms": ms,
                    f"{label}_shared_dense_ms": dense_ms,
                    f"{label}_shared_bound_ms": bound_ms})
    tiers.COUNTERS.update(paths_calls)
    return row


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
                     if "adpcm_" in e.key and "_kernel" in e.key) / 1000
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
    cli_profile(digests, tmp, card, out_dir)
    for c in counters:
        total.update(c)
    return total


PROFILE_CASE = "strcd_flagship"


def cli_profile(digests, tmp, card, out_dir):
    """Phase 9: the flagship strcd once more with PSXAVENC_PROFILE set to a
    directory under ``out_dir``: the CLI writes a Chrome trace there that
    names K1's kernel, says so on stderr, and its output equals the
    digest."""
    import contextlib
    import glob
    import io
    import shutil

    from psxavenc_tpu_torch import cli

    argv, src = next((a, s) for k, a, s in AV_CLI_CASES
                     if k == PROFILE_CASE)
    prof_dir = os.path.join(out_dir, "cli_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    out = os.path.join(tmp, "cuda", "profiled_" + out_name(PROFILE_CASE))
    err = io.StringIO()
    os.environ["PSXAVENC_PROFILE"] = prof_dir
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([*argv, os.path.join(tmp, src), out])
        secs = time.perf_counter() - t0
    finally:
        del os.environ["PSXAVENC_PROFILE"]
    traces = glob.glob(os.path.join(prof_dir, "trace_*.json"))
    if rc != 0 or file_digest(out) != digests[PROFILE_CASE]:
        raise AssertionError(f"profiled cli {' '.join(argv)}: exit {rc} or "
                             "output differs from the JAX package")
    if f"Profile written to {prof_dir}" not in err.getvalue():
        raise AssertionError("profiled cli: no 'Profile written to' line")
    if len(traces) != 1:
        raise AssertionError(f"profiled cli: {len(traces)} traces written")
    with open(traces[0]) as f:
        trace = f.read()
    if "select_pix_kernel" not in trace:
        raise AssertionError("profiled cli: the trace does not name K1's "
                             "kernel select_pix_kernel")
    say(f"[9] cli {' '.join(argv)} with PSXAVENC_PROFILE={prof_dir}: equals "
        f"the JAX package's digest; {secs:.2f} s in process with the "
        f"profiler; trace {os.path.basename(traces[0])} "
        f"({len(trace) / 1e6:.1f} MB) names select_pix_kernel "
        f"{trace.count('select_pix_kernel')} times; 'Profile written to' "
        f"on stderr, on {card}")


def block_stream_kernels(torch, np, synth, card):
    """Phase 10, kernels: K6, K7 and the tail emission (both coefficient
    forms), K9 and K10 == their plain versions on phase 4's first 128
    frames, one of them unfittable. Returns the rows of the kernel
    table."""
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    frames, c, thr, dc_bits, dc_code = symbol_inputs(torch, np, synth)
    nb = c.shape[2]
    results = {}

    def check(*args, **kw):
        return compare(torch, results, 10, *args, card, **kw)

    scale, _, _ = check(
        "select_scale", "(63, NB) int32",
        lambda: bs_cuda.select_scale(c, thr),
        lambda: bs_cuda.select_scale_plain(c, thr),
        select_work_of(torch, nb, False))
    if int(scale[UNFIT_FRAME]) != 64 or not (scale[:UNFIT_FRAME] <= 63).all():
        raise AssertionError("phase 10: the unfittable frame was not found")
    select_checks(torch, np, synth, card, results, c, thr, scale,
                  bs_ops.rearrange_nv21_rows(frames, W, H))
    sidx = torch.where(scale <= 63, scale, 1)
    emit_args = (sidx, dc_code, dc_bits)
    streams, block_bits = check(
        "emit_pack", "(63, NB) int32",
        lambda: bs_cuda.emit_pack(c, *emit_args),
        lambda: bs_cuda.emit_pack_plain(c, *emit_args),
        emit_work_of(rl.emit_pack_work, c, sidx, nb))
    c64 = bs_cuda.select_scale_pix(bs_ops.rearrange_nv21_rows(frames, W, H),
                                   thr)[3]
    check("emit_pack", "(64, nb_pad) int16",
          lambda: bs_cuda.emit_pack(c64, *emit_args),
          lambda: bs_cuda.emit_pack_plain(c64, *emit_args),
          emit_work_of(rl.emit_pack_work, c64, sidx, nb))

    vals32, e0, prep_bits, _ = bs_cuda.emit_prep(c64, *emit_args, eof=0x1FF)
    if not torch.equal(prep_bits, block_bits):
        raise AssertionError("K3's and K7's block totals differ")
    placed = bitpack_cuda.place_vals(vals32, e0, capacity_words=CAP_WORDS)
    for label, coefs in (("(64, nb_pad) int16, one frame unfittable", c64),
                         ("(63, NB) int32, one frame unfittable", c)):
        check_tail(torch, results, 10, label, placed, coefs, emit_args,
                   block_bits, 0x1FF, card)
    if int(block_bits[UNFIT_FRAME].sum()) <= 16 * CAP_WORDS:
        raise AssertionError("phase 10: the unfittable frame fits its "
                             "capacity")

    streams, bb = bitpack_ops.with_eof_block(streams, block_bits, 0x1FF)
    goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
    total = goff[:, -1] + bb[:, -1]
    vals32, e0 = bitpack_ops.streams_to_u32(streams, goff)
    lib_fn, lib_words = scatter_add_call(
        torch, bitpack_ops.u32_to_i32(vals32), e0)
    kw = dict(capacity_words=CAP_WORDS)
    got = check("place_streams", "(u32 words)",
                lambda: bitpack_cuda.place_streams_u32(streams, goff, **kw),
                lambda: bitpack_cuda.place_streams_u32_plain(streams, goff,
                                                             **kw),
                place_streams_work_of(goff), library_fn=lib_fn,
                grid=bitpack_cuda.place_streams_grid(B, CAP_WORDS), ten=True)
    if not torch.equal(got, lib_words):
        raise AssertionError("K9 differs from one scatter_add_ on the "
                             "prepared (words, indices)")
    say("[10] place_streams: one scatter_add_ on the prepared (words, "
        "indices) gives K9's words")
    compare(torch, {}, 10, "place_streams", "(u16 values: the u32 words "
            "and u16_values, the JAX signature)",
            lambda: bitpack_cuda.place_streams(streams, goff, total, **kw),
            lambda: bitpack_cuda.place_streams_plain(streams, goff, total,
                                                     **kw),
            place_streams_work_of(goff), card, ten=True)

    check_pack(torch, results, card, c, emit_args)
    return results, (c64, sidx, dc_code, dc_bits)


def symbol_inputs(torch, np, synth):
    """Phase 10's frames (phase 4's first 128, one of them unfittable) on
    the card and the symbols API's selection inputs: (frames, the (B, 63,
    NB) int32 coefficients, the thresholds, the DC bits and codes)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bs as bs_ops

    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(phase4_frames(np, synth)[:B]).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    budgets[UNFIT_FRAME] = UNFIT_BUDGET
    sel = bs_ops.encode_frames_symbols(api._frames_to_coefs(frames, W, H),
                                       budgets, codec=0, kernel_sweep=False,
                                       emit=False)
    c, dc_bits, dc_code = sel["c"], sel["dc_bits"], sel["dc_code"]
    thr = bs_ops.ac_threshold(budgets, dc_bits.sum(dim=1, dtype=torch.int32),
                              c.shape[2])
    return frames, c, thr, dc_bits, dc_code


def check_pack(torch, results, card, c, emit_args):
    """Phase 10: K10 == its plain version on the symbols of ``c`` at the
    scales of ``emit_args`` ((B, NB + 1, 65) int32), its GB/s and cycle
    sections, and on the adversarial rows; its row goes into
    ``results``."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    sidx, dc_code, dc_bits = emit_args
    codes, bits = bs_ops.emit_symbols_at(c, sidx - 1, dc_bits, dc_code)
    codes, bits = api._with_eof_symbols(codes, bits, 0x1FF)
    codes = bitpack_ops.u32_to_i32(codes)
    bits = bits.to(torch.int32)
    out = compare(torch, results, 10, "pack_block_streams", "(B, NB + 1, 65)",
                  lambda: bitpack_cuda.pack_block_streams(codes, bits),
                  lambda: bitpack_cuda.pack_block_streams_plain(codes, bits),
                  lambda out: rl.pack_work(*codes.shape), card)
    row = results["pack_block_streams"]
    say(f"[10] pack_block_streams {tuple(codes.shape)} int32: "
        f"{rl.nbytes(codes, bits, *out) / row['ms'] / 1e6:.0f} GB/s moved, "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound (target "
        f"50%) on {card}")
    pack_stats_line(torch, codes, bits, card)
    pack_adversarial(torch, codes.device, card)


def pack_stats_line(torch, codes, bits, card):
    """K10's cycle sections (its ``stats_out``), means over its CTAs."""
    from psxavenc_tpu_torch.ops import bitpack_cuda

    names = bitpack_cuda.PACK_STAT_NAMES
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    stats = torch.full((8 * sms, len(names)), -1, dtype=torch.int32,
                       device=codes.device)
    bitpack_cuda.pack_block_streams(codes, bits, stats_out=stats)
    torch.cuda.synchronize()
    st = stats[stats[:, 0] >= 0].to(torch.float64)
    mean = dict(zip(names, st.mean(dim=0).tolist()))
    say(f"[10] pack_block_streams SM cycles per CTA (thread 0's clock, "
        f"means over {len(st)} CTAs, {mean['per_sm']:.0f} an SM): "
        + ", ".join(f"{k[:-7]} {mean[k]:.0f}" for k in names
                    if k.endswith("_cycles"))
        + f"; {mean['tiles']:.1f} tiles a CTA; slowest CTA "
        f"{float(st[:, 4].max()):.0f} cycles (on {card})")
    if len(st) != int(mean["grid"]) or not (st[:, [0, 2, 4]] > 0).all():
        raise AssertionError("pack_block_streams: a CTA wrote no cycle "
                             "sections")


def pack_adversarial(torch, dev, card):
    """Phase 10: K10 == its plain version on the adversarial rows of
    tests/torch_dc_pack_cases.py, 111 rows each (the last tile ragged),
    int64 codes, S = 65, 17, 130 and 600 (rows read from global
    memory)."""
    from psxavenc_tpu_torch.ops import bitpack_cuda

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_dc_pack_cases import PACK_CASES, PACK_SYMBOLS, pack_case

    err = 0
    sizes = PACK_SYMBOLS + (600,)
    for nsym in sizes:
        for case in PACK_CASES:
            codes, bits = pack_case(case, 3, 37, nsym)
            c = torch.from_numpy(codes).to(dev)
            b = torch.from_numpy(bits).to(dev)
            err = max(err, max_abs_err(
                torch, bitpack_cuda.pack_block_streams(c, b),
                bitpack_cuda.pack_block_streams_plain(c, b),
                "pack_block_streams"))
    say(f"[10] pack_block_streams on adversarial rows ({'; '.join(PACK_CASES)}"
        f"; S = {', '.join(map(str, sizes))}; 111 rows each): max |kernel - "
        f"plain| = {err} on {card}")
    if err:
        raise AssertionError("pack_block_streams disagrees with its plain "
                             "version on the adversarial rows")


def select_checks(torch, np, synth, card, results, c, thr, scale, pix):
    """Phase 10, K6's search: the seed cases (frame 5 is unfittable), the
    seeded times, frames made from the pixel rows ``pix`` whose subsample
    misleads, 640x480 frames, and a frame with a coefficient over 16
    bits, which alone is read from global memory."""
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    name = "select_scale"

    def kernel(seeds, stats):
        return bs_cuda.select_scale(c, thr, seeds, stats_out=stats)

    want = bs_cuda.select_scale_plain(c, thr)
    cold = check_seed_cases(torch, 10, name, kernel, want, c.abs(), thr,
                            bs_cuda.K6_THREADS, card)
    seeded_times(torch, 10, name, results[name], kernel, want, cold,
                 bound_evals(torch, scale),
                 bs_cuda.search_groups(c.shape[2], bs_cuda.K6_THREADS), card)
    check_misleading(torch, 10, name, pix, bs_cuda.K6_THREADS,
                     lambda p, cm, t, seeds, st: bs_cuda.select_scale(
                         cm, t, seeds, stats_out=st), card)

    pixb, thrb = big_frames(torch, np, synth)
    cb = bs_ops.pixrows_to_coefs_zz(pixb).contiguous()
    check_big(torch, 10, name,
              lambda seeds, st: bs_cuda.select_scale(cb, thrb, seeds,
                                                     stats_out=st),
              lambda: bs_cuda.select_scale_plain(cb, thrb), cb, thrb, card)

    wide = c[:8].clone()
    wide[2, 5, 7] = -70000
    stats = torch.full((8, len(bs_cuda.STAT_NAMES)), -1, dtype=torch.int32,
                       device=c.device)
    got = bs_cuda.select_scale(wide, thr[:8], stats_out=stats)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, bs_cuda.select_scale_plain(wide, thr[:8]),
                      name)
    say(f"[10] {name} with a coefficient of -70,000 in frame 2 of 8: max "
        f"|kernel - plain| = {err}; reader per frame (1 = global memory) "
        f"{stats[:, 4].tolist()}")
    if err or stats[:, 4].tolist() != [0, 0, 1, 0, 0, 0, 0, 0]:
        raise AssertionError("select_scale: the over-16-bit frame is wrong "
                             "or was not read from global memory")


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
    for name in ("select_scale", "emit_pack", "emit_tail",
                 "place_vals_gather", "place_streams", "pack_block_streams"):
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
                  place_work_of(e0), card, library_fn=lib_fn,
                  grid=bitpack_cuda.place_vals_gather_grid(B, CAP_WORDS))
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


def mesh_phase(torch, np, synth, card):
    """Phase 12: parallel.mesh's split over the card listed twice, and over
    every visible card when there are several: packed_video_step (BS v3dc,
    phase 6's video+noise batch) and unit_encode_step (phase 7's 4,096 x 64
    SPU units) equal the single-device calls, which run before the counts
    are reset. Returns the launch counts of the split runs."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import adpcm_cuda, bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    frames = torch.from_numpy(
        smoke_frames(np, synth, B, seed=14, noise_every=8)).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    units = [torch.from_numpy(a).to(dev) for a in adpcm_units(
        np, synth, ADPCM_STREAMS, ADPCM_CHECK_UNITS)]
    video_kw = dict(codec=2, width=W, height=H, capacity_words=CAP_WORDS)
    want_v = api.bs_encode_frames_packed(frames, budgets, **video_kw)
    want_a = api.spu_encode_batch(*units)
    splits = [[dev, dev]]
    if n_cards > 1:
        splits.append([torch.device("cuda", i) for i in range(n_cards)])
    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, adpcm_cuda.LAUNCHES)
    reset(counters)
    for devices in splits:
        video = mesh.packed_video_step(devices, **video_kw)
        audio = mesh.unit_encode_step(devices, filter_count=5,
                                      shift_range=12)
        got_v = video(frames, budgets)
        got_a = audio(*units)
        torch.cuda.synchronize()
        for k, w in want_v.items():
            if not torch.equal(got_v[k], w):
                raise AssertionError(f"phase 12: packed_video_step over "
                                     f"{devices} differs in {k}")
        for g, w in zip(got_a, want_a):
            if not torch.equal(g, w):
                raise AssertionError(f"phase 12: unit_encode_step over "
                                     f"{devices} differs")
        say(f"[12] split over {[str(d) for d in devices]} "
            f"(torch.cuda.device_count() = {n_cards}): packed_video_step "
            f"shards of {video.shard_shapes(B)} frames (v3dc), "
            f"unit_encode_step shards of "
            f"{audio.shard_shapes(ADPCM_STREAMS)} x {ADPCM_CHECK_UNITS} "
            f"units, each on its own stream; both equal the single-device "
            f"calls on {card}")
    launches = {k: v for c in counters for k, v in c.items()}
    say(f"[12] launches in the split runs: {launches}")
    for name in ("select_scale_pix", "dc_stage", "emit_prep", "place_vals",
                 "emit_tail", "adpcm_encode_units"):
        if launches[name] < sum(len(devices) for devices in splits):
            raise AssertionError(f"phase 12: kernel {name} launched "
                                 f"{launches[name]} times in the split runs")
    return launches


def native_video(torch, np, synth, card):
    """Phase 13, video: api.bs_encode_frames_packed on the card in B-frame
    batches against the native frame encoder on the host, every frame's
    scale, and words, total bits and nonzero count of every frame that
    fits (an unfittable frame's other outputs are left unspecified: the
    caller raises)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.native import tiers

    dev = torch.device("cuda", 0)
    cases = [(W, H, NATIVE_FRAMES, codec, label)
             for codec, label in PHASE4_CODECS]
    cases += [(w, h, n, codec, label) for w, h, n in NATIVE_GEOMETRIES
              for codec, label in PHASE4_CODECS]
    host = {}
    for w, h, n, codec, label in cases:
        if (w, h) not in host:
            host[(w, h)] = mix_frames(np, synth, n, w, h, seed=70 + w + h)
        frames = host[(w, h)]
        budgets = mix_budgets(np, n, w, h, seed=80 + codec + w)
        cap = (int(budgets.max()) - 8 + 1) // 2
        kw = dict(codec=codec, width=w, height=h, capacity_words=cap)
        card_out = {k: [] for k in ("scale", "words", "total_bits",
                                    "nz_count")}
        for b0 in range(0, n, B):
            out = api.bs_encode_frames_packed(
                torch.from_numpy(frames[b0:b0 + B]).to(dev),
                torch.from_numpy(budgets[b0:b0 + B]).to(dev), **kw)
            for k, v in out.items():
                card_out[k].append(v.cpu().numpy())
        card_out = {k: np.concatenate(v) for k, v in card_out.items()}
        card_out["words"] = card_out["words"].view(np.uint16)
        t0 = time.perf_counter()
        nat = tiers.bs_encode_frames(frames, budgets, **kw)
        secs = time.perf_counter() - t0
        fit = nat["scale"] <= 63
        bad = [k for k in ("scale", "words", "total_bits", "nz_count")
               if not np.array_equal(
                   card_out[k] if k == "scale" else card_out[k][fit],
                   nat[k] if k == "scale" else nat[k][fit])]
        if bad:
            raise AssertionError(f"phase 13: the card differs from the "
                                 f"native tier in {bad} ({label}, {w}x{h})")
        say(f"[13] {label} {w}x{h}: {n} frames (video, video+noise, noise; "
            f"budgets {int(budgets.min())}-{int(budgets.max())} bytes, "
            f"{int((~fit).sum())} unfittable): the card's scale, words, "
            f"total bits and nonzero counts equal the native tier's; the "
            f"native tier {n / secs:.1f} frames/s on the host "
            f"({os.cpu_count()} cores; the card is {card})")


def native_encoder(torch, np, synth, card):
    """Phase 13, the encoder: BsFrameEncoder on the CPU with
    PSXAVENC_VIDEO_TIER=native against the card's encoder (the default
    tier) on phase 6's 1,024 frames of each mix: equal frame buffers and
    quant-scale sums."""
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    from psxavenc_tpu_torch.native import tiers

    old = os.environ.get("PSXAVENC_VIDEO_TIER")
    for label in ("video", "video+noise", "noise"):
        frames = list(e2e_frames(np, synth, label))
        budgets = [BUDGET] * len(frames)
        calls = tiers.COUNTERS["bs_encode_frames"]
        os.environ.pop("PSXAVENC_VIDEO_TIER", None)
        card_enc = BsFrameEncoder(0, W, H, "cuda")
        got = card_enc.encode_frames(frames, budgets)
        if tiers.COUNTERS["bs_encode_frames"] != calls or \
                card_enc.tier != "device":
            raise AssertionError("phase 13: the card's encoder called the "
                                 "native library")
        os.environ["PSXAVENC_VIDEO_TIER"] = "native"
        try:
            nat_enc = BsFrameEncoder(0, W, H, "cpu")
        finally:
            if old is None:
                os.environ.pop("PSXAVENC_VIDEO_TIER", None)
            else:
                os.environ["PSXAVENC_VIDEO_TIER"] = old
        if nat_enc.tier != "native":
            raise AssertionError(f"phase 13: the host encoder's tier is "
                                 f"{nat_enc.tier}")
        t0 = time.perf_counter()
        want = nat_enc.encode_frames(frames, budgets)
        secs = time.perf_counter() - t0
        card_enc.close()
        nat_enc.close()
        if tiers.COUNTERS["bs_encode_frames"] != calls + 1:
            raise AssertionError("phase 13: the native encoder did not make "
                                 "one native call")
        if [b.tobytes() for b, _ in got] != [b.tobytes() for b, _ in want] \
                or [i for _, i in got] != [i for _, i in want] \
                or card_enc.quant_scale_sum != nat_enc.quant_scale_sum:
            raise AssertionError(f"phase 13, {label}: the card's encoder "
                                 "differs from the native tier's")
        say(f"[13] BsFrameEncoder {label}, {len(frames)} frames {W}x{H}: "
            f"the card's frame buffers and quant-scale sum "
            f"({card_enc.quant_scale_sum}) equal the native tier's; native "
            f"{len(frames) / secs:.1f} frames/s end to end on the host "
            f"({os.cpu_count()} cores)")


def native_adpcm(torch, np, synth, card):
    """Phase 13, ADPCM: K5 on the card against the native unit encoder on
    random streams (SPU and both XA settings, partial and masked units,
    nonzero states) and on a 60 s stereo XA track's two streams: headers,
    sample values and the state after every unit."""
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.ops import adpcm_cuda

    dev = torch.device("cuda", 0)
    cases = [(f"{NATIVE_STREAMS} random streams x {NATIVE_UNITS} units",
              adpcm_units(np, synth, NATIVE_STREAMS, NATIVE_UNITS, seed=90),
              variant) for variant in ADPCM_VARIANTS]
    cases.append(("a 60 s stereo XA track's two streams",
                  xa_track_units(np, synth), (4, 12)))
    for label, host, (fc, sr) in cases:
        h, words, s1, s2 = adpcm_cuda.encode_units(
            *(torch.from_numpy(a).to(dev) for a in host), filter_count=fc,
            shift_range=sr)
        got = (h.cpu().numpy(),
               adpcm_cuda.unpack_words(words, sr).cpu().numpy(),
               s1.cpu().numpy(), s2.cpu().numpy())
        t0 = time.perf_counter()
        want = tiers.adpcm_encode_units(*host, fc, sr)
        secs = time.perf_counter() - t0
        for name, g, w in zip(("headers", "values", "s1", "s2"), got, want):
            if not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
                raise AssertionError(f"phase 13: K5 ({fc}, {sr}) differs "
                                     f"from the native tier in {name} on "
                                     f"{label}")
        n_units = host[1].size
        say(f"[13] adpcm ({fc}, {sr}), {label}: K5's headers, values and "
            f"states equal the native tier's on all {n_units} units; the "
            f"native tier {n_units / secs:.0f} units/s on the host "
            f"({os.cpu_count()} cores; the card is {card})")


def native_phase(torch, np, synth, card):
    """Phase 13: the card against the port's native C++ tiers. Returns the
    launch counts of its card runs."""
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.ops import adpcm_cuda, bitpack_cuda, bs_cuda

    t0 = time.time()
    tiers.lib()
    say(f"[13] native tiers built (g++) in {time.time() - t0:.1f} s")
    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, adpcm_cuda.LAUNCHES)
    reset(counters)
    native_video(torch, np, synth, card)
    native_encoder(torch, np, synth, card)
    native_adpcm(torch, np, synth, card)
    launches = {k: v for c in counters for k, v in c.items()}
    say(f"[13] launches in phase 13's card runs: {launches}")
    for name in ("select_scale_pix", "dc_stage", "emit_prep", "place_vals",
                 "emit_tail", "adpcm_encode_units"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 13: kernel {name} never launched")
    return launches


BENCH_TIMEOUT_S = 300


def bench_phase(torch, card):
    """Phase 14: ``bench_torch.py --quick`` in a subprocess on the card
    (the kernels and the native library already built); its last line
    parsed and printed."""
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--quick"],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"phase 14: bench_torch.py --quick exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if not line.get("value", 0) > 0 \
            or line.get("device") != torch.cuda.get_device_name(0):
        raise AssertionError(f"phase 14: bench_torch.py's last line {line}")
    say(f"[14] bench_torch.py --quick exited 0 in {time.time() - t0:.1f} s "
        f"on {card}; its last line: {json.dumps(line)}")


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
    ptxas_report(_build.build_log, "bs_nv21.cu", ("nv21_pix_dc_kernel",))
    ptxas_report(_build.build_log, "bs_select.cu",
                 ("select_pix_kernel", "select_kernel"))
    ptxas_report(_build.build_log, "bs_emit.cu",
                 ("emit_prep_kernel", "emit_pack_kernel", "emit_tail_kernel"))
    spills = ptxas_report(_build.build_log, "bs_dc.cu",
                          ("dc_chain_kernel", "empty_kernel"))
    spills.update(ptxas_report(_build.build_log, "bitpack_streams.cu",
                               ("pack_kernel", "place_streams_kernel")))
    ptxas_report(_build.build_log, "bitpack_place.cu", ("place_kernel",))
    ptxas_report(_build.build_log, "bitpack_gather.cu", ("gather_kernel",))
    if spills.get("dc_chain_kernel", 1) or spills.get("pack_kernel", 1):
        raise AssertionError("K2 or K10 spills (or ptxas did not report "
                             "them)")

    rows = check_kernels(torch, np, synth, card)
    video = main_path(torch, np, synth, digests)
    with tempfile.TemporaryDirectory() as tmp:
        write_inputs(synth, tmp)
        cli_phase(digests, tmp)
        throughput(torch, np, synth, card, out_dir)
        full, ref, rows["adpcm_encode_units"] = adpcm_kernel(torch, np,
                                                             synth, card)
        rows["adpcm_encode_units"].update(adpcm_batch(torch, full, ref,
                                                      card))
        del full, ref
        rows["adpcm_encode_units"].update(adpcm_tracks(torch, np, synth,
                                                       card))
        rows["adpcm_encode_units"].update(adpcm_shared_rows(torch, np, synth,
                                                            card))
        av = av_path(torch, digests, tmp, card, out_dir)
        k10_rows, k3_inputs = block_stream_kernels(torch, np, synth, card)
        for name, row in k10_rows.items():
            rows.setdefault(name, row)      # the tail emission: phase 3's
        blocks = symbols_and_packers(torch, np, synth, digests, card)
        rows["place_vals_gather"] = gather_kernel(torch, k3_inputs, card)
        del k3_inputs
        multi = multi_file(torch, digests, synth, tmp, card)
    split = mesh_phase(torch, np, synth, card)
    from psxavenc_tpu_torch.native import tiers
    if any(tiers.COUNTERS.values()):
        raise AssertionError(f"phases 4-12 called the native library: "
                             f"{tiers.COUNTERS}")
    native = native_phase(torch, np, synth, card)
    bench_phase(torch, card)

    kernels = []
    for name, source, replaces in KERNELS:
        launches = sum(path.get(name, 0)
                       for path in (video, av, blocks, multi, split, native))
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
