"""Argument system — flag-compatible with the reference CLI.

Grammar (psxavenc/args.c:683-737): single-dash single-character options, each
either a flag or consuming the next argv entry; ``--`` disables option
parsing; the first two positionals are input and output. ``-t`` must precede
format-specific options; option resolution order is general -> audio ->
video -> container per format (args.c:621-649). Defaults per format follow
args.c:149-187.
"""

import sys
from dataclasses import dataclass, field

FLAG_IGNORE_OPTIONS = 1 << 0
FLAG_QUIET = 1 << 1
FLAG_HIDE_PROGRESS = 1 << 2
FLAG_PRINT_HELP = 1 << 3
FLAG_PRINT_VERSION = 1 << 4
FLAG_OVERRIDE_LOOP_POINT = 1 << 5
FLAG_SPU_ENABLE_LOOP = 1 << 6
FLAG_SPU_NO_LEADING_DUMMY = 1 << 7
FLAG_BS_IGNORE_ASPECT = 1 << 8
FLAG_STR_TRAILING_AUDIO = 1 << 9

FORMAT_INVALID = -1
(FORMAT_XA, FORMAT_XACD, FORMAT_SPU, FORMAT_VAG, FORMAT_SPUI, FORMAT_VAGI,
 FORMAT_STR, FORMAT_STRCD, FORMAT_STRSPU, FORMAT_STRV, FORMAT_SBS) = range(11)

FORMAT_NAMES = ["xa", "xacd", "spu", "vag", "spui", "vagi", "str", "strcd",
                "strspu", "strv", "sbs"]

BS_CODEC_V2, BS_CODEC_V3, BS_CODEC_V3DC = range(3)
BS_CODEC_NAMES = ["v2", "v3", "v3dc"]


@dataclass
class Args:
    flags: int = 0
    format: int = FORMAT_INVALID
    input_file: str = None
    output_file: str = None
    swresample_options: str = None
    swscale_options: str = None

    audio_frequency: int = 0
    audio_channels: int = 0
    audio_bit_depth: int = 0
    audio_xa_file: int = 0
    audio_xa_channel: int = 0
    audio_interleave: int = 0
    audio_loop_point: int = -1

    video_codec: int = BS_CODEC_V2
    video_width: int = 320
    video_height: int = 240

    str_fps_num: int = 15
    str_fps_den: int = 1
    str_cd_speed: int = 2
    str_video_id: int = 0x8001
    str_audio_id: int = 0x0001
    alignment: int = 0
    extra: dict = field(default_factory=dict)


class ArgError(Exception):
    pass


def _err(msg):
    print(msg, file=sys.stderr)
    raise ArgError(msg)


def init_default_args(args):
    # args.c:149-187
    if args.format in (FORMAT_XA, FORMAT_XACD, FORMAT_STR, FORMAT_STRCD):
        args.audio_frequency = 37800
    else:
        args.audio_frequency = 44100
    if args.format in (FORMAT_SPU, FORMAT_VAG):
        args.audio_channels = 1
    else:
        args.audio_channels = 2
    args.audio_bit_depth = 4
    args.audio_xa_file = 0
    args.audio_xa_channel = 0
    args.audio_interleave = 2048
    args.audio_loop_point = -1
    args.video_codec = BS_CODEC_V2
    args.video_width = 320
    args.video_height = 240
    args.str_fps_num = 15
    args.str_fps_den = 1
    args.str_cd_speed = 2
    args.str_video_id = 0x8001
    args.str_audio_id = 0x0001
    if args.format in (FORMAT_SPU, FORMAT_VAG):
        args.alignment = 64
    elif args.format == FORMAT_SBS:
        args.alignment = 8192
    else:
        args.alignment = 2048


def _strtol(value, base=0):
    """C strtol: parse the longest valid prefix; 0 when none."""
    value = value.strip()
    neg = value.startswith("-")
    body = value[1:] if value[:1] in "+-" else value
    if base == 0:
        if body[:2].lower() == "0x":
            base, body = 16, body[2:]
            digits = "0123456789abcdef"
        elif body[:1] == "0" and len(body) > 1:
            base, body = 8, body[1:]
            digits = "01234567"
        else:
            base, digits = 10, "0123456789"
    else:
        digits = "0123456789abcdef"[:base]
    n = 0
    while n < len(body) and body[n].lower() in digits:
        n += 1
    if n == 0:
        return 0
    v = int(body[:n], base)
    return -v if neg else v


def _parse_int(name, value, min_value, max_value=-1):
    if value is None:
        _err(f"Missing {name} value after option")
    v = _strtol(value)
    if v < min_value or (max_value >= 0 and v > max_value):
        if max_value >= 0:
            _err(f"Invalid {name}: {v} (must be in {min_value}-{max_value} "
                 "range)")
        _err(f"Invalid {name}: {v} (must be {min_value} or greater)")
    return v


def _parse_int_one_of(name, value, a, b):
    if value is None:
        _err(f"Missing {name} value after option")
    v = _strtol(value)
    if v not in (a, b):
        _err(f"Invalid {name}: {v} (must be {a} or {b})")
    return v


def _parse_enum(name, value, choices):
    if value is None:
        _err(f"Missing {name} value after option")
    if value in choices:
        return choices.index(value)
    _err(f"Invalid {name}: {value}\nMust be one of the following values:\n"
         + "".join(f"    {c}\n" for c in choices))


def _parse_general(args, opt, param):
    if opt == "-":
        args.flags |= FLAG_IGNORE_OPTIONS
        return 1
    if opt == "h":
        args.flags |= FLAG_PRINT_HELP
        return 1
    if opt == "V":
        args.flags |= FLAG_PRINT_VERSION
        return 1
    if opt == "q":
        args.flags |= FLAG_QUIET | FLAG_HIDE_PROGRESS
        return 1
    if opt == "t":
        args.format = _parse_enum("format", param, FORMAT_NAMES)
        init_default_args(args)
        return 2
    if opt == "R":
        if param is None:
            _err("Missing libswresample parameter list after option")
        args.swresample_options = param
        return 2
    if opt == "S":
        if param is None:
            _err("Missing libswscale parameter list after option")
        args.swscale_options = param
        return 2
    return 0


def _parse_xa(args, opt, param):
    if opt == "f":
        args.audio_frequency = _parse_int_one_of("sample rate", param, 18900,
                                                 37800)
        return 2
    if opt == "c":
        args.audio_channels = _parse_int_one_of("channel count", param, 1, 2)
        return 2
    if opt == "b":
        args.audio_bit_depth = _parse_int_one_of("bit depth", param, 4, 8)
        return 2
    if opt == "F":
        args.audio_xa_file = _parse_int("file number", param, 0, 255)
        return 2
    if opt == "C":
        args.audio_xa_channel = _parse_int("channel number", param, 0, 31)
        return 2
    return 0


def _parse_spu(args, opt, param):
    if opt == "f":
        args.audio_frequency = _parse_int("sample rate", param, 1)
        return 2
    if opt == "a":
        args.alignment = _parse_int("alignment", param, 1)
        return 2
    if opt == "l":
        args.flags |= FLAG_OVERRIDE_LOOP_POINT | FLAG_SPU_ENABLE_LOOP
        args.audio_loop_point = _parse_int("loop offset", param, 0)
        return 2
    if opt == "n":
        args.flags |= FLAG_OVERRIDE_LOOP_POINT
        args.audio_loop_point = -1
        return 1
    if opt == "L":
        args.flags |= FLAG_OVERRIDE_LOOP_POINT | FLAG_SPU_ENABLE_LOOP
        args.audio_loop_point = -1
        return 1
    if opt == "D":
        args.flags |= FLAG_SPU_NO_LEADING_DUMMY
        return 1
    return 0


def _parse_spui(args, opt, param):
    if opt == "f":
        args.audio_frequency = _parse_int("sample rate", param, 1)
        return 2
    if opt == "c":
        args.audio_channels = _parse_int("channel count", param, 1)
        return 2
    if opt == "i":
        v = _parse_int("interleave", param, 16)
        args.audio_interleave = (v + 15) & ~15
        return 2
    if opt == "a":
        args.alignment = _parse_int("alignment", param, 1)
        return 2
    if opt == "l":
        args.flags |= FLAG_OVERRIDE_LOOP_POINT
        args.audio_loop_point = _parse_int("loop offset", param, 0)
        return 2
    if opt == "n":
        args.flags |= FLAG_OVERRIDE_LOOP_POINT
        args.audio_loop_point = -1
        return 1
    if opt == "L":
        args.flags |= FLAG_SPU_ENABLE_LOOP
        return 1
    if opt == "D":
        args.flags |= FLAG_SPU_NO_LEADING_DUMMY
        return 1
    return 0


def _parse_bs(args, opt, param):
    if opt == "v":
        args.video_codec = _parse_enum("video codec", param, BS_CODEC_NAMES)
        return 2
    if opt == "s":
        if param is None:
            _err("Missing video size after option")
        w, sep, h = param.partition("x")
        if not sep:
            _err("Invalid video size (must be specified as <width>x<height>)")
        args.video_width = _strtol(w, 10)
        args.video_height = _strtol(h, 10)
        if not (16 <= args.video_width <= 640):
            _err(f"Invalid video width: {args.video_width} (must be in "
                 "16-640 range)")
        if not (16 <= args.video_height <= 512):
            _err(f"Invalid video height: {args.video_height} (must be in "
                 "16-512 range)")
        args.video_width = (args.video_width + 15) & ~15
        args.video_height = (args.video_height + 15) & ~15
        return 2
    if opt == "I":
        args.flags |= FLAG_BS_IGNORE_ASPECT
        return 1
    return 0


def _parse_str(args, opt, param):
    if opt == "r":
        if param is None:
            _err("Missing frame rate value after option")
        num, sep, den = param.partition("/")
        args.str_fps_num = _strtol(num, 10)
        args.str_fps_den = _strtol(den, 10) if sep else 1
        if args.str_fps_num <= 0 or args.str_fps_den <= 0:
            _err("Invalid frame rate (must be a non-zero integer or "
                 "fraction)")
        fps = args.str_fps_num // args.str_fps_den
        if fps < 1 or fps > 60:
            _err(f"Invalid frame rate: {args.str_fps_num}/{args.str_fps_den}"
                 " (must be in 1-60 range)")
        return 2
    if opt == "x":
        args.str_cd_speed = _parse_int_one_of("CD-ROM speed", param, 1, 2)
        return 2
    if opt == "T":
        args.str_video_id = _parse_int("video track type ID", param, 0,
                                       0xFFFF)
        return 2
    if opt == "A":
        args.str_audio_id = _parse_int("audio track type ID", param, 0,
                                       0xFFFF)
        return 2
    if opt == "X":
        args.flags |= FLAG_STR_TRAILING_AUDIO
        return 1
    return 0


def _parse_sbs(args, opt, param):
    if opt == "a":
        args.alignment = _parse_int("video frame size", param, 256)
        return 2
    return 0


# Per-format parser wiring (args.c:521-619).
_FORMAT_PARSERS = {
    FORMAT_XA: (_parse_xa, None, None),
    FORMAT_XACD: (_parse_xa, None, None),
    FORMAT_SPU: (_parse_spu, None, None),
    FORMAT_VAG: (_parse_spu, None, None),
    FORMAT_SPUI: (_parse_spui, None, None),
    FORMAT_VAGI: (_parse_spui, None, None),
    FORMAT_STR: (_parse_xa, _parse_bs, _parse_str),
    FORMAT_STRCD: (_parse_xa, _parse_bs, _parse_str),
    FORMAT_STRSPU: (_parse_spui, _parse_bs, _parse_str),
    FORMAT_STRV: (None, _parse_bs, _parse_str),
    FORMAT_SBS: (None, _parse_bs, _parse_sbs),
}

# Help text byte-identical to the reference (args.c:114-518).
USAGE = """\
Usage:
    psxavenc -t xa|xacd   [xa-options]                              <in> <out.xa>
    psxavenc -t spu|vag   [spu-options]                             <in> <out.vag>
    psxavenc -t spui|vagi [spui-options]                            <in> <out.vag>
    psxavenc -t str|strcd [xa-options]   [bs-options] [str-options] <in> <out.str>
    psxavenc -t strv                     [bs-options] [str-options] <in> <out.str>
    psxavenc -t sbs                      [bs-options] [sbs-options] <in> <out.sbs>
"""

_GENERAL_HELP = """\
General options:
    -h                Show this help message and exit
    -V                Show version information and exit
    -q                Suppress all non-error messages
    -t format         Use (or show help for) specified output format
                        xa:     [A.] XA-ADPCM, 2336-byte sectors
                        xacd:   [A.] XA-ADPCM, 2352-byte sectors
                        spu:    [A.] raw SPU-ADPCM mono data
                        spui:   [A.] raw SPU-ADPCM interleaved data
                        vag:    [A.] .vag SPU-ADPCM mono
                        vagi:   [A.] .vag SPU-ADPCM interleaved
                        str:    [AV] .str video + XA-ADPCM, 2336-byte sectors
                        strcd:  [AV] .str video + XA-ADPCM, 2352-byte sectors
                        strv:   [.V] .str video, 2048-byte sectors
                        sbs:    [.V] .sbs video
    -R key=value,...  Pass custom options to libswresample (see FFmpeg docs)
    -S key=value,...  Pass custom options to libswscale (see FFmpeg docs)
"""

_XA_HELP = """\
XA-ADPCM options:
    [-f 18900|37800] [-c 1|2] [-b 4|8] [-F 0-255] [-C 0-31]

    -f 18900|37800    Use specified sample rate (default 37800)
    -c 1|2            Use specified channel count (default 2)
    -b 4|8            Use specified bit depth (default 4)
    -F 0-255          Set CD-XA file number (for both audio and video, default 0)
    -C 0-31           Set CD-XA channel number (for both audio and video, default 0)
"""

_SPU_HELP = """\
Mono SPU-ADPCM options:
    [-f freq] [-a size] [-l ms | -n | -L] [-D]

    -f freq           Use specified sample rate (default 44100)
    -a size           Pad audio data excluding header to multiple of given size (default 64)
    -l ms             Add loop point at specified timestamp (in milliseconds, overrides any loop point present in input file)
    -n                Do not set loop end flag nor add a loop point (even if input file has one)
    -L                Set ADPCM loop end flag at end of data but do not add a loop point (even if input file has one)
    -D                Do not prepend encoded data with a dummy silent block to reset decoder state
"""

_SPUI_HELP = """\
Interleaved SPU-ADPCM options:
    [-f freq] [-c channels] [-i size] [-a size] [-l ms | -n] [-L] [-D]

    -f freq           Use specified sample rate (default 44100)
    -c channels       Use specified channel count (default 2)
    -i size           Use specified channel interleave size (default 2048)
    -a size           Pad .vag header and each audio chunk to multiples of given size (default 2048)
    -l ms             Store specified timestamp in file header as loop point (in milliseconds, overrides any loop point present in input file)
    -n                Do not store any loop point in file header (even if input file has one)
    -L                Set ADPCM loop end flag at the end of each audio chunk (separately from loop point in file header)
    -D                Do not prepend first chunk's data with a dummy silent block to reset decoder state
"""

_BS_HELP = """\
Video options:
    [-v v2|v3|v3dc] [-s WxH] [-I]

    -v codec          Use specified video codec
                        v2:   MDEC BS v2 (default)
                        v3:   MDEC BS v3
                        v3dc: MDEC BS v3, expect decoder to wrap DC coefficients
    -s WxH            Rescale input file to fit within specified size (16x16-640x512 in 16-pixel increments, default 320x240)
    -I                Force stretching to given size without preserving aspect ratio
"""

_STR_HELP = """\
.str container options:
    [-r num[/den]] [-x 1|2] [-T id] [-A id] [-X]

    -r num[/den]      Set video frame rate to specified integer or fraction (default 15)
    -x 1|2            Set CD-ROM speed the file is meant to played at (default 2)
    -T id             Tag video sectors with specified .str type ID (default 0x8001)
    -A id             Tag SPU-ADPCM sectors with specified .str type ID (default 0x0001)
    -X                Place audio sectors after corresponding video sectors rather than ahead of them
"""

_SBS_HELP = """\
.sbs container options:
    [-a size]

    -a size           Set size of each video frame (default 8192)
"""

# Per-format usage line + help sections (args.c:521-619 wiring).
_FORMAT_USAGE = {
    FORMAT_XA: "psxavenc -t xa [xa-options] <in> <out.xa>",
    FORMAT_XACD: "psxavenc -t xacd [xa-options] <in> <out.xa>",
    FORMAT_SPU: "psxavenc -t spu [spu-options] <in> <out>",
    FORMAT_VAG: "psxavenc -t vag [spu-options] <in> <out.vag>",
    FORMAT_SPUI: "psxavenc -t spui [spui-options] <in> <out>",
    FORMAT_VAGI: "psxavenc -t vagi [spui-options] <in> <out.vag>",
    FORMAT_STR:
        "psxavenc -t str [xa-options] [bs-options] [str-options] "
        "<in> <out.str>",
    FORMAT_STRCD:
        "psxavenc -t strcd [xa-options] [bs-options] [str-options] "
        "<in> <out.str>",
    FORMAT_STRSPU:
        "psxavenc -t strspu [spui-options] [bs-options] [str-options] "
        "<in> <out.str>",
    FORMAT_STRV:
        "psxavenc -t strv [bs-options] [str-options] <in> <out.str>",
    FORMAT_SBS:
        "psxavenc -t sbs [bs-options] [sbs-options] <in> <out.sbs>",
}

_FORMAT_HELP_SECTIONS = {
    FORMAT_XA: [_XA_HELP],
    FORMAT_XACD: [_XA_HELP],
    FORMAT_SPU: [_SPU_HELP],
    FORMAT_VAG: [_SPU_HELP],
    FORMAT_SPUI: [_SPUI_HELP],
    FORMAT_VAGI: [_SPUI_HELP],
    FORMAT_STR: [_XA_HELP, _BS_HELP, _STR_HELP],
    FORMAT_STRCD: [_XA_HELP, _BS_HELP, _STR_HELP],
    FORMAT_STRSPU: [_SPUI_HELP, _BS_HELP, _STR_HELP],
    FORMAT_STRV: [_BS_HELP, _STR_HELP],
    FORMAT_SBS: [_BS_HELP, _SBS_HELP],
}


def print_help(fmt):
    """Full help, or format-scoped help after -t; text byte-identical to
    the reference (args.c:114-518, 651-681)."""
    if fmt == FORMAT_INVALID:
        print(USAGE + "\n" + "\n".join(
            [_GENERAL_HELP, _XA_HELP, _SPU_HELP, _SPUI_HELP, _BS_HELP,
             _STR_HELP, _SBS_HELP]))
        return
    sections = "\n".join(_FORMAT_HELP_SECTIONS[fmt])
    print(f"Usage:\n    {_FORMAT_USAGE[fmt]}\n\n{_GENERAL_HELP}\n"
          f"{sections}")


def parse_args(args, options):
    """args.c:683-737. Returns True when encoding should proceed."""
    i = 0
    n = len(options)
    while i < n:
        opt = options[i]
        if len(opt) == 2 and opt[0] == "-" and \
                not (args.flags & FLAG_IGNORE_OPTIONS):
            param = options[i + 1] if i + 1 < n else None
            parsed = _parse_general(args, opt[1], param)
            if parsed == 0 and args.format != FORMAT_INVALID:
                for p in _FORMAT_PARSERS[args.format]:
                    if p is not None:
                        parsed = p(args, opt[1], param)
                        if parsed:
                            break
            if parsed == 0:
                if args.format == FORMAT_INVALID:
                    _err(f"Unknown general option: -{opt[1]}\n(if this is a "
                         "format-specific option, it shall be passed after "
                         "-t)")
                _err(f"Unknown option for format "
                     f"{FORMAT_NAMES[args.format]}: -{opt[1]}")
            i += parsed
            continue
        if args.input_file is None:
            args.input_file = opt
        elif args.output_file is None:
            args.output_file = opt
        else:
            _err("There should be no arguments after the output file path")
        i += 1

    if args.flags & FLAG_PRINT_HELP:
        print_help(args.format)
        return False
    if args.flags & FLAG_PRINT_VERSION:
        from . import __version__
        print(f"psxavenc-tpu {__version__}")
        return False
    if args.format == FORMAT_INVALID or args.input_file is None or \
            args.output_file is None:
        # args.c:722-733 trailer, byte-identical.
        print(USAGE, file=sys.stderr)
        print("For more information about the options supported for a "
              "given output format, run:\n    psxavenc -t <format> -h\n"
              "To view the full list of supported options, run:\n"
              "    psxavenc -h", file=sys.stderr)
        return False
    return True
