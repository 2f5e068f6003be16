"""Batch job runner: encode many files in one process, batched on the
device (or split over several cards).

Counterpart of ``psxavenc_tpu/batch.py``. The device work is grouped
across files:

- **audio jobs** (xa/xacd/spu/vag/spui/vagi): a planning pass runs each
  container with an encoder that captures its ADPCM units (gathered on
  the host) and stops it; every file's channel streams then concatenate
  on the batch axis, and ALL files of a (filter_count, shift_range) class
  encode in ONE K5 launch. The muxers replay with their slices, so the
  bytes equal serial runs.
- **video jobs** (str/strcd/strv/sbs): every file's budgeted frames join
  one frame sequence per (codec, geometry) class; ``BsFrameEncoder``
  encodes it in its usual device batches, so the tail frames of one file
  share a batch with the head frames of the next.
- **streaming-tier audio jobs** (inputs the ingest streams) keep their
  bounded chunk feeds but run in concurrent threads, each round of
  chunks encoded in one shared K5 launch (``_ChunkBatcher``).

The device is explicit: ``run_jobs(..., device=...)``, by default the
card; ``main`` takes it from PSXAVENC_PLATFORM as the CLI does (``cuda``
by default: every visible card, exit 1 without one; ``cpu`` runs the
native C++ tiers, or the kernels' plain versions with
PSXAVENC_VIDEO_TIER=device and PSXAVENC_NO_NATIVE_ADPCM=1). Given
several devices, as the JAX runner's mesh branch does, the grouped audio
call splits its streams over them
(``parallel.mesh.unit_encode_step``, B padded to a multiple) and the
video groups' frame batches split over them (``BsFrameEncoder``); the
rest runs on the first. Grouping is on by default;
PSXAVENC_BATCH_GROUP=0 runs the jobs one after another (the same bytes
either way).

Usage:
    python -m psxavenc_tpu_torch.batch jobs.txt
    python -m psxavenc_tpu_torch.batch - < jobs.txt

Each non-empty, non-comment line of the job file is a full psxavenc
argument vector, e.g.:

    -t vag -f 44100 voices/a.wav out/a.vag
    -t xacd -F 1 music/theme.wav out/theme.xa
    -t strcd -s 320x240 fmv/intro.avi out/intro.str
"""

import contextlib
import io as iomod
import os
import shlex
import sys
import threading
import time

import numpy as np
import torch

from . import cli
from . import cli_args as ca
from .io import ingest
from .models import adpcm_stream as streams
from .parallel import mesh
from .utils import spans

AUDIO_FORMATS = (ca.FORMAT_XA, ca.FORMAT_XACD, ca.FORMAT_SPU,
                 ca.FORMAT_VAG, ca.FORMAT_SPUI, ca.FORMAT_VAGI)
VIDEO_FORMATS = (ca.FORMAT_STR, ca.FORMAT_STRCD, ca.FORMAT_STRV,
                 ca.FORMAT_SBS)


class _CaptureDone(Exception):
    """Raised by the planning pass once the container has handed its
    device work to the batch planner."""


def _request(channel_samples, offsets, limits, filter_count, shift_range,
             prev1, prev2):
    """One unit-encode request, its (B, T, 28) int32 units and (B, T)
    clipped limits gathered on the host (CPU tensors)."""
    units, lim = streams.gather_units(
        torch.from_numpy(np.array(channel_samples, np.int32)),
        torch.from_numpy(np.array(offsets, np.int64)),
        torch.from_numpy(np.array(limits, np.int64)))
    return {"units": units, "lim": lim, "fc": filter_count,
            "sr": shift_range, "prev1": prev1, "prev2": prev2}


def _capture_encoder(store):
    """unit_encoder that records the request and stops the container (the
    planning pass needs the layout, not the bytes)."""

    def enc(channel_samples, offsets, limits, filter_count, shift_range,
            prev1=None, prev2=None, device=None):
        store.append(_request(channel_samples, offsets, limits,
                              filter_count, shift_range, prev1, prev2))
        raise _CaptureDone()

    return enc


def _replay_encoder(results):
    """unit_encoder that returns the grouped encode's slices in order."""

    def enc(*_args, **_kwargs):
        return results.pop(0)

    return enc


def _encode_audio_groups(reqs, device, quiet=False):
    """One K5 launch per (filter_count, shift_range) class over the
    requests' streams concatenated on the batch axis; returns each
    request's (headers, values, prev1, prev2), host numpy."""
    out = [None] * len(reqs)
    groups = {}
    for i, r in enumerate(reqs):
        groups.setdefault((r["fc"], r["sr"]), []).append(i)
    for (fc, sr), idxs in groups.items():
        with spans.span("batch.encode"):
            t_max = max(reqs[i]["lim"].shape[1] for i in idxs)
            b_tot = sum(reqs[i]["lim"].shape[0] for i in idxs)
            units = torch.zeros((b_tot, t_max, streams.SAMPLES_PER_UNIT),
                                dtype=torch.int32)
            lim = torch.zeros((b_tot, t_max), dtype=torch.int32)
            p1 = np.zeros(b_tot, np.int32)
            p2 = np.zeros(b_tot, np.int32)
            state_t = np.zeros(b_tot, np.int64)
            b0 = 0
            for i in idxs:
                r = reqs[i]
                b, t = r["lim"].shape
                units[b0:b0 + b, :t] = r["units"]
                lim[b0:b0 + b, :t] = r["lim"]
                state_t[b0:b0 + b] = t - 1
                if r["prev1"] is not None:
                    p1[b0:b0 + b] = r["prev1"]
                    p2[b0:b0 + b] = r["prev2"]
                b0 += b
            if not quiet:
                print(f"[batch] audio group fc={fc} sr={sr}: "
                      f"{len(idxs)} jobs, {b_tot} streams x {t_max} units "
                      f"in one device call", file=sys.stderr)
            h, n, s1, s2 = _grouped_unit_encode(units, lim, fc, sr, p1, p2,
                                                state_t, device)
            b0 = 0
            for i in idxs:
                b, t = reqs[i]["lim"].shape
                out[i] = (h[b0:b0 + b, :t], n[b0:b0 + b, :t],
                          s1[b0:b0 + b], s2[b0:b0 + b])
                b0 += b
    return out


def _grouped_unit_encode(units, lim, fc, sr, p1, p2, state_t, devices):
    """One K5 launch on the device, or, with several devices and at least
    as many streams, one on each, the streams split over them
    (``parallel.mesh.unit_encode_step``; B padded with masked streams to a
    multiple, as the JAX runner's mesh branch does)."""
    devices = mesh.device_list(devices)
    n_dev = len(devices)
    B = lim.shape[0]
    if n_dev == 1 or B < n_dev:
        return streams.encode_prepared_units(units, lim, fc, sr, prev1=p1,
                                             prev2=p2, state_t=state_t,
                                             device=devices[0])
    pad = -(-B // n_dev) * n_dev - B
    units = torch.cat([units, units.new_zeros((pad,) + units.shape[1:])])
    lim = torch.cat([lim, lim.new_zeros((pad,) + lim.shape[1:])])
    p1, p2 = (torch.from_numpy(np.concatenate([p, np.zeros(pad, np.int32)]))
              for p in (p1, p2))
    step = mesh.unit_encode_step(devices, filter_count=fc, shift_range=sr)
    h, values, s1, s2 = step(units, lim, p1, p2)
    rows = torch.arange(B, device=s1.device)
    t_idx = streams.upload(np.asarray(state_t, np.int64), s1.device)
    h, values = h[:B].to(torch.uint8), values[:B].to(torch.uint8)
    s1, s2 = s1[rows, t_idx], s2[rows, t_idx]
    with spans.span("adpcm.read_back"):
        return (streams.read_back(h), streams.read_back(values),
                streams.read_back(s1), streams.read_back(s2))


class _ThreadStderr:
    """Per-thread stderr demux for concurrently running streaming jobs:
    registered threads write to a private buffer (dumped in job order
    when the phase ends), everyone else passes through to the real
    stream, so progress lines from parallel jobs never interleave."""

    def __init__(self, real):
        self.real = real
        self.bufs = {}

    def register(self):
        buf = iomod.StringIO()
        self.bufs[threading.get_ident()] = buf
        return buf

    def write(self, s):
        buf = self.bufs.get(threading.get_ident())
        (buf if buf is not None else self.real).write(s)
        return len(s)

    def flush(self):
        if threading.get_ident() not in self.bufs:
            self.real.flush()

    def isatty(self):
        return False

    def close(self):
        # Loggers may cache this object as their stream and close it at
        # exit; the real stream's lifetime is not ours to end.
        pass


class _ChunkBatcher:
    """Groups the streaming tier's per-chunk unit encodes across
    concurrently running jobs into shared K5 launches.

    Each streaming audio job runs in its own thread with a ``chunked``
    unit encoder (the containers keep their bounded chunk feeds:
    ``vag.SPU_CHUNK_BLOCKS``, ``xa.AUDIO_CHUNK_SECTORS_SOLO``). A chunk
    encode enqueues its units (gathered on the host) and blocks; when
    every still-active job has a chunk pending, the thread that completed
    the round encodes it through the grouped call of the whole-file path.
    The K5 launch, its count and the copy back to the host happen under
    the condition lock, on that thread's current (default) stream. State
    threading stays per job (the containers pass prev1/prev2), so the
    bytes equal serial execution. A single streaming job's rounds are
    singletons: the serial chunk feed."""

    def __init__(self, device):
        self.device = device
        self.cv = threading.Condition()
        self.active = 0
        self.pending = []
        self.rounds = 0
        self.grouped_rounds = 0
        self.max_round = 0

    def register(self):
        with self.cv:
            self.active += 1

    def unregister(self):
        with self.cv:
            self.active -= 1
            if self.pending and len(self.pending) >= self.active:
                self._flush_locked()

    def encoder(self):
        def enc(channel_samples, offsets, limits, filter_count,
                shift_range, prev1=None, prev2=None, device=None):
            slot = _request(channel_samples, offsets, limits, filter_count,
                            shift_range, prev1, prev2)
            slot.update(done=False, out=None, error=None)
            with self.cv:
                self.pending.append(slot)
                if len(self.pending) >= self.active:
                    self._flush_locked()
                else:
                    while not slot["done"]:
                        self.cv.wait()
            if slot["error"] is not None:
                raise RuntimeError(
                    f"shared chunk encode failed: {slot['error']}")
            return slot["out"]

        enc.chunked = True
        return enc

    def _flush_locked(self):
        reqs, self.pending = self.pending, []
        self.rounds += 1
        if len(reqs) > 1:
            self.grouped_rounds += 1
            self.max_round = max(self.max_round, len(reqs))
        try:
            results = _encode_audio_groups(reqs, self.device, quiet=True)
        except BaseException as e:
            # Mark every slot failed before re-raising: the other jobs'
            # threads wait in enc() and would hang forever otherwise
            # (each reports the error as its own).
            for slot in reqs:
                slot["error"] = e
                slot["done"] = True
            self.cv.notify_all()
            raise
        for slot, res in zip(reqs, results):
            slot["out"] = res
            slot["done"] = True
        self.cv.notify_all()


def _finish(args, dec, device, key=None, **inject):
    """The mux pass of a planned job (span ``batch.replay``, keyed by the
    job's index ``key``): open the output and run the container with the
    injected encoder or frames; returns the exit code."""
    with spans.span("batch.replay", key):
        try:
            output = open(args.output_file, "wb")
        except OSError:
            print(f"Failed to open output file: {args.output_file}",
                  file=sys.stderr)
            return 1
        try:
            with output:
                return cli._dispatch(args, dec, output, device, **inject)
        except (RuntimeError, NotImplementedError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1


def _run_streaming_audio(plan, rcs, device, quiet=False):
    """Run audio jobs ``plan`` ((job index, args, decoder) each)
    concurrently, their chunk rounds batched into shared K5 launches
    (bytes equal to serial); ``rcs[job index]`` gets each exit code.
    ``run_jobs`` sends the jobs whose input the ingest streams."""
    batcher = _ChunkBatcher(device)
    mux = _ThreadStderr(sys.stderr)
    bufs = [None] * len(plan)

    def run_one(k, i, args, dec):
        bufs[k] = mux.register()
        try:
            rcs[i] = _finish(args, dec, device, key=i,
                             unit_encoder=batcher.encoder())
        except BaseException:
            rcs[i] = 1
            raise
        finally:
            batcher.unregister()

    real_stderr = sys.stderr
    sys.stderr = mux
    try:
        # Register every job before any thread starts: a fast job that
        # registered itself could reach its first chunk while the others
        # were still starting (pending >= active with active == 1) and
        # flush a singleton round.
        for _ in plan:
            batcher.register()
        threads = [threading.Thread(target=run_one, args=(k, i, a, d),
                                    daemon=True)
                   for k, (i, a, d) in enumerate(plan)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.stderr = real_stderr
    for buf in bufs:
        if buf is not None and buf.getvalue():
            sys.stderr.write(buf.getvalue())
    if not quiet and batcher.grouped_rounds:
        print(f"[batch] streaming tier: {len(plan)} jobs, "
              f"{batcher.grouped_rounds}/{batcher.rounds} chunk rounds "
              f"shared a device call (widest {batcher.max_round})",
              file=sys.stderr)


def _video_plan(args, dec):
    """(sources, budgets) of a video job: the frame/budget pairing the
    muxers consume (frame k takes source min(k - 1, last))."""
    from .containers import strf

    if args.format == ca.FORMAT_SBS:
        budgets = [args.alignment] * dec.video_frame_count
    elif args.format in (ca.FORMAT_STR, ca.FORMAT_STRCD):
        _, _, budgets = strf.str_schedule(args, dec, quiet=True)
    else:
        _, _, budgets = strf.strspu_schedule(args, dec, quiet=True)
    frames = dec.video_window()
    total = len(frames)
    sources = [frames[min(k, total - 1)] for k in range(len(budgets))]
    return sources, budgets


def _encode_video_groups(plans, device, quiet=False):
    """One frame sequence per (codec, w, h): the encoder's device batches
    span job boundaries (budgets ride as data)."""
    from .models.bs_video import BsFrameEncoder

    out = [None] * len(plans)
    groups = {}
    for i, (args, dec, sources, budgets) in enumerate(plans):
        key = (args.video_codec, dec.video_width, dec.video_height)
        groups.setdefault(key, []).append(i)
    for (codec, w, h), idxs in groups.items():
        all_sources, all_budgets, spans = [], [], []
        for i in idxs:
            _, _, sources, budgets = plans[i]
            spans.append((len(all_sources), len(sources)))
            all_sources.extend(sources)
            all_budgets.extend(budgets)
        if not quiet:
            print(f"[batch] video group {w}x{h} codec={codec}: "
                  f"{len(idxs)} jobs, {len(all_sources)} frames in "
                  f"shared device batches", file=sys.stderr)
        enc = BsFrameEncoder(codec, w, h, device)
        results = enc.encode_frames(all_sources, all_budgets)
        for i, (start, count) in zip(idxs, spans):
            out[i] = results[start:start + count]
    return out


def _serial(argv, device):
    """One job as ``cli.main`` runs it, on ``device``."""
    args = ca.Args()
    try:
        if not ca.parse_args(args, list(argv)):
            return 1
    except ca.ArgError:
        return 1
    return cli.encode(args, device)


def run_jobs(jobs, group=True, quiet=False, device="cuda"):
    """Run parsed job argvs on ``device`` (one device, or a sequence that
    the grouped calls split over); returns per-job exit codes. With
    ``group``, audio unit encodes and video frame encodes batch across
    files; the output bytes equal serial execution either way."""
    device = mesh.device_list(device)
    t0 = time.monotonic()
    rcs = [None] * len(jobs)

    parsed = []
    with spans.span("batch.parse"):
        for i, argv in enumerate(jobs):
            args = ca.Args()
            try:
                ok = ca.parse_args(args, list(argv))
            except ca.ArgError:
                ok = False
            if not ok:
                rcs[i] = 1
                continue
            parsed.append((i, args))

    plan_audio = []   # (job index, args, dec, request index)
    plan_video = []   # (job index, args, dec, sources, budgets)
    plan_stream = []  # (job index, args, dec): streaming-tier audio
    serial = []       # (job index, argv)
    audio_reqs = []

    for i, args in parsed:
        fmt = args.format
        if not group or (fmt not in AUDIO_FORMATS
                         and fmt not in VIDEO_FORMATS):
            serial.append((i, jobs[i]))
            continue
        with spans.span("batch.plan", i):
            try:
                dec = ingest.open_av_data(args, cli._DECODER_FLAGS[fmt])
            except ingest.OpenError:
                print(f"Failed to open input file: {args.input_file}",
                      file=sys.stderr)
                rcs[i] = 1
                continue
            except Exception as e:  # noqa: BLE001 — mirror cli.encode
                print(str(e), file=sys.stderr)
                print(f"Failed to open input file: {args.input_file}",
                      file=sys.stderr)
                rcs[i] = 1
                continue
            if isinstance(dec, ingest.StreamingDecoder):
                if fmt in AUDIO_FORMATS:
                    plan_stream.append((i, args, dec))
                else:
                    # Streaming video encodes lazily through the frame
                    # encoder's own device batches; run it serially.
                    dec.close()
                    serial.append((i, jobs[i]))
                continue
            if fmt in AUDIO_FORMATS:
                n_before = len(audio_reqs)
                capture = _capture_encoder(audio_reqs)
                try:
                    with contextlib.redirect_stderr(iomod.StringIO()):
                        cli._dispatch(args, dec, iomod.BytesIO(), device,
                                      unit_encoder=capture)
                except _CaptureDone:
                    pass
                except (RuntimeError, NotImplementedError) as e:
                    print(f"Error: {e}", file=sys.stderr)
                    rcs[i] = 1
                    continue
                dec.reset()
                if len(audio_reqs) == n_before:
                    # No unit encode happened (an empty input): the planning
                    # pass finished the job against a throwaway sink; run it
                    # for real, serially.
                    serial.append((i, jobs[i]))
                    continue
                plan_audio.append((i, args, dec, n_before))
            else:
                try:
                    sources, budgets = _video_plan(args, dec)
                except (RuntimeError, NotImplementedError) as e:
                    print(f"Error: {e}", file=sys.stderr)
                    rcs[i] = 1
                    continue
                plan_video.append((i, args, dec, sources, budgets))

    audio_results = _encode_audio_groups(audio_reqs, device, quiet=quiet) \
        if audio_reqs else []
    video_results = _encode_video_groups(
        [(a, d, s, b) for (_, a, d, s, b) in plan_video], device,
        quiet=quiet) if plan_video else []

    for (i, args, dec, req0) in plan_audio:
        # Each audio container makes exactly one unit-encode call.
        rcs[i] = _finish(args, dec, device, key=i,
                         unit_encoder=_replay_encoder([audio_results[req0]]))
    if plan_stream:
        _run_streaming_audio(plan_stream, rcs, device, quiet=quiet)
    for k, (i, args, dec, _s, _b) in enumerate(plan_video):
        rcs[i] = _finish(args, dec, device, key=i,
                         frame_results=video_results[k])
    for (i, argv) in serial:
        rcs[i] = _serial(argv, device)

    for i, argv in enumerate(jobs):
        status = "ok" if rcs[i] == 0 else f"FAILED ({rcs[i]})"
        if not quiet:
            print(f"[{i + 1}/{len(jobs)}] {' '.join(map(str, argv))}: "
                  f"{status}", file=sys.stderr)
    dt = time.monotonic() - t0
    failures = sum(1 for rc in rcs if rc != 0)
    if not quiet:
        print(f"{len(jobs) - failures}/{len(jobs)} jobs succeeded in "
              f"{dt:.1f}s", file=sys.stderr)
    return rcs


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 1
    device = cli._devices()
    if device is None:
        return 1
    try:
        if argv[0] == "-":
            lines = sys.stdin.readlines()
        else:
            with open(argv[0]) as f:
                lines = f.readlines()
    except OSError as e:
        print(f"Failed to open job file: {e}", file=sys.stderr)
        return 1
    jobs = [shlex.split(line) for line in lines
            if line.strip() and not line.strip().startswith("#")]
    group = os.environ.get("PSXAVENC_BATCH_GROUP", "1") != "0"
    rcs = run_jobs(jobs, group=group, device=device)
    return 1 if any(rc != 0 for rc in rcs) else 0


if __name__ == "__main__":
    sys.exit(main())
