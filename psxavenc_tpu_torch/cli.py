"""Command-line front end of the torch backend, argv-compatible with
``psxavenc_tpu.cli`` (psxavenc/main.c:51-212) for the ported formats:
``-t sbs`` and ``-t strv``. Every other format exits 1.

The device comes from PSXAVENC_PLATFORM: ``cuda`` (the default) or
``cpu``. Without a CUDA device the default exits 1; it does not carry on
on the CPU.

    python -m psxavenc_tpu_torch.cli -t sbs -v v3dc in.avi out.sbs
"""

import os
import sys

from psxavenc_tpu import cli_args as ca
from psxavenc_tpu.io import ingest

_DECODER_FLAGS = {
    ca.FORMAT_STRV: ingest.DECODER_USE_VIDEO | ingest.DECODER_VIDEO_REQUIRED,
    ca.FORMAT_SBS: ingest.DECODER_USE_VIDEO | ingest.DECODER_VIDEO_REQUIRED,
}

_BS_CODEC_BANNER = ["BS v2", "BS v3", "BS v3 (with DC wrapping)"]


def _info(args, msg):
    if not (args.flags & ca.FLAG_QUIET):
        print(msg, file=sys.stderr)


def _video_banner(args):
    fps = args.str_fps_num / args.str_fps_den
    return (f"Video format: {_BS_CODEC_BANNER[args.video_codec]}, "
            f"{args.video_width}x{args.video_height}, {fps:.2f} fps")


def _device():
    """The torch device named by PSXAVENC_PLATFORM, or None (with the
    reason on stderr) when it is unknown or absent."""
    import torch

    plat = os.environ.get("PSXAVENC_PLATFORM", "cuda") or "cuda"
    if plat == "cpu":
        return torch.device("cpu")
    if plat in ("cuda", "gpu"):
        if torch.cuda.is_available():
            return torch.device("cuda", 0)
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

    if args.format not in _DECODER_FLAGS:
        print(f"Error: format {ca.FORMAT_NAMES[args.format]} is not yet "
              "ported to the torch backend (ported: sbs, strv)",
              file=sys.stderr)
        return 1
    device = _device()
    if device is None:
        return 1

    try:
        dec = ingest.open_av_data(args, _DECODER_FLAGS[args.format])
    except ingest.OpenError:
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


def _dispatch(args, dec, output, device):
    if args.format == ca.FORMAT_STRV:
        from .containers import strf
        _info(args, _video_banner(args))
        strf.encode_file_strspu(args, dec, output, device)
    else:
        from .containers import sbs
        _info(args, _video_banner(args))
        sbs.encode_file_sbs(args, dec, output, device)

    if not (args.flags & ca.FLAG_HIDE_PROGRESS):
        print("\nDone.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
