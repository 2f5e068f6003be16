"""Progress/speed reporting, format-compatible with filefmt.c:36-54 and the
per-loop progress lines (filefmt.c:199-208, 259-268, 364-374, 504-515,
648-658): one update per wall-clock second, printing counters and the
realtime encoding-speed multiple; suppressed by -q."""

import sys
import time

from .. import cli_args as ca


class Progress:
    def __init__(self, args):
        self.args = args
        self.start_time = 0
        self.last_update = 0

    def _elapsed(self):
        # filefmt.c:39-54: whole seconds; returns 0 until a new second ticks.
        if self.start_time > 0:
            t = int(time.time()) - self.start_time
        else:
            t = 0
            self.start_time = int(time.time())
        if t <= self.last_update:
            return 0
        self.last_update = t
        return t

    def _enabled(self):
        return not (self.args.flags & ca.FLAG_HIDE_PROGRESS)

    def print_spu(self, block_count, frequency):
        t = self._elapsed()
        if self._enabled() and t:
            speed = (block_count * 28) / (frequency * t)
            sys.stderr.write(
                f"\rBlock: {block_count:6d} | Encoding speed: {speed:5.2f}x")

    def print_spui(self, chunk_count, samples_per_chunk, frequency):
        t = self._elapsed()
        if self._enabled() and t:
            speed = (chunk_count * samples_per_chunk) / (frequency * t)
            sys.stderr.write(
                f"\rChunk: {chunk_count:6d} | Encoding speed: {speed:5.2f}x")

    def print_xa(self, lba, samples_per_sector, frequency):
        t = self._elapsed()
        if self._enabled() and t:
            speed = (lba * samples_per_sector) / (frequency * t)
            sys.stderr.write(
                f"\rLBA: {lba:6d} | Encoding speed: {speed:5.2f}x")

    def print_str(self, frame, lba, quant_scale_sum, fps_num, fps_den):
        t = self._elapsed()
        if self._enabled() and t:
            avg_q = quant_scale_sum / frame if frame else float("nan")
            speed = (frame * fps_den) / (t * fps_num)
            sys.stderr.write(
                f"\rFrame: {frame:4d} | LBA: {lba:6d} | "
                f"Avg. q. scale: {avg_q:5.2f} | "
                f"Encoding speed: {speed:5.2f}x")

    def print_sbs(self, frame, quant_scale_sum, fps_num, fps_den):
        t = self._elapsed()
        if self._enabled() and t:
            avg_q = quant_scale_sum / frame if frame else float("nan")
            speed = (frame * fps_den) / (t * fps_num)
            sys.stderr.write(
                f"\rFrame: {frame:4d} | Avg. q. scale: {avg_q:5.2f} | "
                f"Encoding speed: {speed:5.2f}x")
