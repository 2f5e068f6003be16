"""The .str muxer's frame pacing (psxavenc filefmt.c:399-429): a frame's
video budget in bytes, the benchmark's own copy of the arithmetic."""


def xa_interleave(rate, channels, bits):
    """Sectors per XA audio sector at 1x (libpsxav adpcm.c)."""
    n = 2 if channels == 2 else 4
    if rate == 18900:
        n <<= 1
    if bits == 4:
        n <<= 1
    return n


def frame_budgets(config, n_frames):
    """Byte budgets of the first ``n_frames`` frames of a -t str movie
    with audio: the interleave gives the video sectors per period, and
    the running remainder decides how many whole sectors each frame
    gets."""
    interleave = xa_interleave(config["audio_frequency"],
                               config["audio_channels"],
                               config["audio_bit_depth"]) \
        * config["cd_speed"]
    video_sectors = interleave - 1
    num = 75 * config["cd_speed"] * video_sectors * config["fps_den"]
    den = interleave * config["fps_num"]
    acc, out = 0, []
    for _ in range(n_frames):
        acc += num
        out.append(acc // den * config["sector_payload_bytes"])
        acc %= den
    return out
