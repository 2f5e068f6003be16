""".sbs container: fixed-size BS frames back to back (filefmt.c:633-663).

Counterpart of ``psxavenc_tpu/containers/sbs.py``: frames encode in
look-ahead device batches through the ``.str`` muxer's frame feed and are
written as they are produced; every frame gets the -a alignment as its
budget.
"""

from psxavenc_tpu.io.ingest import source_for
from psxavenc_tpu.utils.progress import Progress

from ..models.bs_video import BsFrameEncoder
from . import strf


def encode_file_sbs(args, dec, output, device):
    enc = BsFrameEncoder(args.video_codec, dec.video_width,
                         dec.video_height, device)
    total = dec.video_frame_count
    feed = strf._FrameFeed(enc, source_for(dec), [args.alignment] * total,
                           total)

    progress = Progress(args)
    for f in range(1, total + 1):
        buffer, _ = feed.frame(f)
        feed.evict_below(f + 1)
        output.write(buffer.tobytes())
        # The reference prints the 0-based loop index j but a quant sum
        # that already includes frame j (filefmt.c:642-658).
        progress.print_sbs(f - 1, feed.quant_scale_sum(f),
                           args.str_fps_num, args.str_fps_den)
    if hasattr(dec, "close"):
        dec.close()
