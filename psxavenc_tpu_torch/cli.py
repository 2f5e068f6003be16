"""Command-line front end of the torch backend, argv-compatible with
``psxavenc_tpu.cli`` and the reference encoder (psxavenc/main.c:51-212):
the same formats, flags, defaults and stderr banners.

The device comes from PSXAVENC_PLATFORM: ``cuda`` (the default) or
``cpu``. ``cuda`` takes every visible card: video frame batches split
over them (``parallel.mesh``), audio runs on the first; with one card
nothing is split. Without a CUDA device the default exits 1; it does not
carry on on the CPU. ``cpu`` encodes with the native C++ tiers
(``native/tiers.py``); PSXAVENC_VIDEO_TIER=device and
PSXAVENC_NO_NATIVE_ADPCM=1 run the kernels' plain versions instead.

PSXAVENC_PROFILE=DIR runs the job under ``torch.profiler`` (host
activity, and the cards' when the job runs on them) and writes a Chrome
trace (``trace_<pid>_<ns>.json``) into DIR, also when the job fails; the
CLI then prints "Profile written to DIR" on stderr unless ``-q``. The
trace carries the port's spans (``utils/spans.py``, on only while a
profiler runs) as ``user_annotation`` events on the clock of the kernels
and copies, one a batch, chunk or file: ``bs.open``, ``bs.stack``,
``bs.stage``, ``bs.launch``, ``bs.wait``, ``bs.collect`` (the video
encoder), ``ingest.open``, ``ingest.demux``, ``ingest.resample``,
``ingest.nv21``, ``ingest.stack``, ``str.schedule``, ``str.sectors``,
``xa.sectors``, ``xa.encode``, ``xa.assemble``, ``batch.parse``,
``batch.plan``, ``batch.encode``, ``batch.replay``, ``adpcm.upload``,
``adpcm.kernel`` and ``adpcm.read_back``. The profiler's per-kernel device
times read low late in a long process: time kernels with CUDA events or
graph replays, and use the trace for the order of operations and the
host's stages.

    python -m psxavenc_tpu_torch.cli -t strcd -x 2 in.avi out.str
"""

import os
import sys
import time

from . import cli_args as ca
from .io import ingest

# main.c:37-49
_DECODER_FLAGS = {
    ca.FORMAT_XA: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_XACD: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_SPU: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_VAG: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_SPUI: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_VAGI: ingest.DECODER_USE_AUDIO | ingest.DECODER_AUDIO_REQUIRED,
    ca.FORMAT_STR: ingest.DECODER_USE_AUDIO | ingest.DECODER_USE_VIDEO
    | ingest.DECODER_VIDEO_REQUIRED,
    ca.FORMAT_STRCD: ingest.DECODER_USE_AUDIO | ingest.DECODER_USE_VIDEO
    | ingest.DECODER_VIDEO_REQUIRED,
    ca.FORMAT_STRSPU: ingest.DECODER_USE_AUDIO | ingest.DECODER_USE_VIDEO
    | ingest.DECODER_VIDEO_REQUIRED,
    ca.FORMAT_STRV: ingest.DECODER_USE_VIDEO
    | ingest.DECODER_VIDEO_REQUIRED,
    ca.FORMAT_SBS: ingest.DECODER_USE_VIDEO | ingest.DECODER_VIDEO_REQUIRED,
}

_BS_CODEC_BANNER = ["BS v2", "BS v3", "BS v3 (with DC wrapping)"]


def _info(args, msg):
    if not (args.flags & ca.FLAG_QUIET):
        print(msg, file=sys.stderr)


def _audio_banner_xa(args):
    st = "stereo" if args.audio_channels == 2 else "mono"
    return (f"Audio format: XA-ADPCM, {args.audio_frequency} Hz "
            f"{args.audio_bit_depth}-bit {st}, F={args.audio_xa_file} "
            f"C={args.audio_xa_channel}")


def _video_banner(args):
    fps = args.str_fps_num / args.str_fps_den
    return (f"Video format: {_BS_CODEC_BANNER[args.video_codec]}, "
            f"{args.video_width}x{args.video_height}, {fps:.2f} fps")


def _devices():
    """The torch devices named by PSXAVENC_PLATFORM (every visible card for
    ``cuda``), or None (with the reason on stderr) when it is unknown or
    absent."""
    import torch

    plat = os.environ.get("PSXAVENC_PLATFORM", "cuda") or "cuda"
    if plat == "cpu":
        return [torch.device("cpu")]
    if plat in ("cuda", "gpu"):
        if torch.cuda.is_available():
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        print("Error: no CUDA device is available (set "
              "PSXAVENC_PLATFORM=cpu to encode on the host)",
              file=sys.stderr)
        return None
    print(f"Error: unknown PSXAVENC_PLATFORM {plat!r} (cuda or cpu)",
          file=sys.stderr)
    return None


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    args = ca.Args()
    try:
        if not ca.parse_args(args, list(argv)):
            return 1
    except ca.ArgError:
        return 1

    devices = _devices()
    if devices is None:
        return 1
    profile_dir = os.environ.get("PSXAVENC_PROFILE")
    if profile_dir:
        return _profiled(args, devices, profile_dir)
    return encode(args, devices)


def _profiled(args, devices, profile_dir):
    """``encode`` under torch.profiler; the trace is written in a
    ``finally``, so a failing job writes one too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        return encode(args, devices)
    finally:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
        _info(args, f"Profile written to {profile_dir}")


def encode(args, device):
    """Encode one parsed job on ``device`` (one device, or a sequence whose
    cards video frame batches split over): open the input and the output,
    run the container muxer; returns the exit code (errors on stderr)."""
    try:
        dec = ingest.open_av_data(args, _DECODER_FLAGS[args.format])
    except ingest.OpenError:
        # Detail already printed by the ingest layer (decoding.c prints
        # its own message before main.c:66-68 adds this line).
        print(f"Failed to open input file: {args.input_file}",
              file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — mirror the reference's exit path
        print(str(e), file=sys.stderr)
        print(f"Failed to open input file: {args.input_file}",
              file=sys.stderr)
        return 1

    try:
        output = open(args.output_file, "wb")
    except OSError:
        print(f"Failed to open output file: {args.output_file}",
              file=sys.stderr)
        return 1

    try:
        return _dispatch(args, dec, output, device)
    except (RuntimeError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        output.close()


def _dispatch(args, dec, output, device, unit_encoder=None,
              frame_results=None):
    """Route to the container muxer (psxavenc_tpu/cli.py:114-171).
    ``unit_encoder`` and ``frame_results`` are the batch runner's
    injection points: an ADPCM unit encoder that captures or replays, and
    video frames it already encoded (``batch.py``). ``device``: one device
    or a sequence; the video muxers take all of it, the audio muxers the
    first device."""
    from .parallel import mesh

    devices = mesh.device_list(device)
    device = devices[0]
    fmt = args.format
    if fmt in (ca.FORMAT_XA, ca.FORMAT_XACD):
        from .containers import xa as xamod
        _info(args, _audio_banner_xa(args))
        xamod.encode_file_xa(args, dec, output, device,
                             unit_encoder=unit_encoder)
    elif fmt in (ca.FORMAT_SPU, ca.FORMAT_VAG):
        if not (args.flags & ca.FLAG_OVERRIDE_LOOP_POINT):
            args.audio_loop_point = ingest.get_av_loop_point(dec, args)
            if args.audio_loop_point >= 0:
                args.flags |= ca.FLAG_SPU_ENABLE_LOOP
        from .containers import vag as vagmod
        _info(args, f"Audio format: SPU-ADPCM, {args.audio_frequency} "
                    "Hz mono")
        vagmod.encode_file_spu(args, dec, output, device,
                               unit_encoder=unit_encoder)
    elif fmt in (ca.FORMAT_SPUI, ca.FORMAT_VAGI):
        if not (args.flags & ca.FLAG_OVERRIDE_LOOP_POINT):
            args.audio_loop_point = ingest.get_av_loop_point(dec, args)
        from .containers import vag as vagmod
        _info(args, f"Audio format: SPU-ADPCM, {args.audio_frequency} "
                    f"Hz {args.audio_channels} channels, "
                    f"interleave={args.audio_interleave}")
        vagmod.encode_file_spui(args, dec, output, device,
                                unit_encoder=unit_encoder)
    elif fmt in (ca.FORMAT_STR, ca.FORMAT_STRCD):
        from .containers import strf
        if dec.has_audio:
            _info(args, _audio_banner_xa(args))
        _info(args, _video_banner(args))
        strf.encode_file_str(args, dec, output, devices,
                             frame_results=frame_results)
    elif fmt == ca.FORMAT_STRSPU:
        # The reference prints this and still exits 0 (main.c:159-162).
        print("This format is not currently supported", file=sys.stderr)
    elif fmt == ca.FORMAT_STRV:
        from .containers import strf
        if dec.has_audio:
            _info(args, f"Audio format: SPU-ADPCM, "
                        f"{args.audio_frequency} Hz "
                        f"{args.audio_channels} channels, "
                        f"interleave={args.audio_interleave}")
        _info(args, _video_banner(args))
        strf.encode_file_strspu(args, dec, output, devices,
                                frame_results=frame_results)
    elif fmt == ca.FORMAT_SBS:
        from .containers import sbs
        _info(args, _video_banner(args))
        sbs.encode_file_sbs(args, dec, output, devices,
                            frame_results=frame_results)

    if not (args.flags & ca.FLAG_HIDE_PROGRESS):
        print("\nDone.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
