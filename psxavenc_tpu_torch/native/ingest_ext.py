"""ctypes loader for the native FFmpeg-based ingest (psxav_ingest.cpp).

Builds on demand with g++ into the package's ``build/`` directory (ignored
by git) against the system libav*/libswresample/libswscale — the same L0
libraries the reference encoder links (meson.build:9-17). When the
toolchain or headers are unavailable, ``load()`` returns None and the
Python ingest falls back to its ffmpeg-free paths.

Three entry styles map to the native API:

- :func:`ingest` — whole-file decode (the default tier), optionally
  ``count_only`` (decode + count, store nothing: the cheap schedule pass
  of streaming mode).
- :func:`probe` — open + find_stream_info only (duration estimate for the
  automatic streaming decision; never decodes, never prints).
- :class:`IngestStream` — bounded-memory streaming handle: ``fill`` to a
  need, ``take_audio`` / ``take_video``, close.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "psxav_ingest.cpp"
_BUILD_DIR = _DIR.parent / "build"

_FFLIBS = ["libavformat", "libavcodec", "libavutil", "libswresample",
           "libswscale"]

FLAG_COUNT_ONLY = 1 << 4


class Req(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_char_p),
        ("flags", ctypes.c_int),
        ("audio_frequency", ctypes.c_int),
        ("audio_channels", ctypes.c_int),
        ("video_width", ctypes.c_int),
        ("video_height", ctypes.c_int),
        ("ignore_aspect", ctypes.c_int),
        ("fps_num", ctypes.c_int),
        ("fps_den", ctypes.c_int),
        ("quiet", ctypes.c_int),
        ("swr_options", ctypes.c_char_p),
        ("sws_options", ctypes.c_char_p),
    ]


class Res(ctypes.Structure):
    _fields_ = [
        ("audio", ctypes.POINTER(ctypes.c_int16)),
        ("audio_count", ctypes.c_longlong),
        ("video", ctypes.POINTER(ctypes.c_uint8)),
        ("video_frames", ctypes.c_longlong),
        ("video_width", ctypes.c_int),
        ("video_height", ctypes.c_int),
        ("has_audio", ctypes.c_int),
        ("has_video", ctypes.c_int),
        ("is_wav", ctypes.c_int),
        ("has_loop_meta", ctypes.c_int),
        ("loop_meta_ms", ctypes.c_longlong),
        ("n_chapters", ctypes.c_int),
        ("chapter0_ms", ctypes.c_longlong),
        ("duration_us", ctypes.c_longlong),
    ]


_lib = None
_load_failed = False


def _build():
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"libpsxav_ingest_{tag}.so"
    if out.exists():
        return out
    pc = subprocess.run(
        ["pkg-config", "--cflags", "--libs"] + _FFLIBS,
        capture_output=True, text=True)
    if pc.returncode != 0:
        raise RuntimeError("ffmpeg dev libraries not found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp = pathlib.Path(td) / out.name
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC),
             "-o", str(tmp)] + pc.stdout.split(),
            check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def load():
    """The ctypes library, or None when it cannot be built/loaded."""
    global _lib, _load_failed
    # The disable knob must beat the cache: tests toggle it after the
    # extension has already been loaded by an earlier encode.
    if os.environ.get("PSXAVENC_NO_NATIVE_INGEST"):
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
    except Exception:  # noqa: BLE001 — any build/load issue disables it
        _load_failed = True
        return None
    lib.psxn_ingest_open.restype = ctypes.c_int
    lib.psxn_ingest_open.argtypes = [ctypes.POINTER(Req),
                                     ctypes.POINTER(Res)]
    lib.psxn_ingest_free.restype = None
    lib.psxn_ingest_free.argtypes = [ctypes.POINTER(Res)]
    lib.psxn_probe.restype = ctypes.c_int
    lib.psxn_probe.argtypes = [ctypes.POINTER(Req), ctypes.POINTER(Res)]
    lib.psxn_stream_open.restype = ctypes.c_void_p
    lib.psxn_stream_open.argtypes = [ctypes.POINTER(Req),
                                     ctypes.POINTER(Res),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.psxn_stream_fill.restype = ctypes.c_int
    lib.psxn_stream_fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong]
    lib.psxn_stream_buffered.restype = None
    lib.psxn_stream_buffered.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.psxn_stream_take_audio.restype = ctypes.c_longlong
    lib.psxn_stream_take_audio.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_longlong]
    lib.psxn_stream_take_video.restype = ctypes.c_longlong
    lib.psxn_stream_take_video.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.psxn_stream_close.restype = None
    lib.psxn_stream_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _make_req(path, *, flags, audio_frequency, audio_channels, video_width,
              video_height, ignore_aspect, fps_num, fps_den, quiet,
              swr_options=None, sws_options=None):
    return Req(
        path=os.fsencode(path), flags=flags,
        audio_frequency=audio_frequency, audio_channels=audio_channels,
        video_width=video_width, video_height=video_height,
        ignore_aspect=int(bool(ignore_aspect)), fps_num=fps_num,
        fps_den=fps_den, quiet=int(bool(quiet)),
        swr_options=swr_options.encode() if swr_options else None,
        sws_options=sws_options.encode() if sws_options else None)


def _meta_dict(res):
    return {
        "video_width": res.video_width,
        "video_height": res.video_height,
        "has_audio": bool(res.has_audio),
        "has_video": bool(res.has_video),
        "is_wav": bool(res.is_wav),
        "loop_meta_ms": (int(res.loop_meta_ms)
                         if res.has_loop_meta else None),
        "n_chapters": int(res.n_chapters),
        "chapter0_ms": int(res.chapter0_ms),
        "duration_us": int(res.duration_us),
    }


def ingest(path, *, count_only=False, **kwargs):
    """Run the native whole-file ingest. Returns a dict, or raises
    OSError(code) with code 1 (message already printed) / 2 (silent
    failure). With ``count_only`` the decode runs identically but stores
    nothing; ``audio``/``video`` are empty and ``audio_count``/
    ``video_frame_count`` carry the exact totals."""
    lib = load()
    assert lib is not None
    flags = kwargs.pop("flags")
    if count_only:
        flags |= FLAG_COUNT_ONLY
    req = _make_req(path, flags=flags, **kwargs)
    res = Res()
    rc = lib.psxn_ingest_open(ctypes.byref(req), ctypes.byref(res))
    if rc != 0:
        raise OSError(rc, "native ingest failed")
    try:
        audio = np.zeros(0, np.int16)
        if res.audio_count and res.audio:
            audio = np.ctypeslib.as_array(
                res.audio, shape=(res.audio_count,)).copy()
        video = np.zeros((0, 0), np.uint8)
        fsz = res.video_width * res.video_height * 3 // 2
        if res.video_frames and res.video:
            video = np.ctypeslib.as_array(
                res.video, shape=(res.video_frames * fsz,)).copy()
            video = video.reshape(res.video_frames, fsz)
        out = _meta_dict(res)
        out.update(audio=audio, video=video,
                   audio_count=int(res.audio_count),
                   video_frame_count=int(res.video_frames))
        return out
    finally:
        lib.psxn_ingest_free(ctypes.byref(res))


def probe(path, **kwargs):
    """Stream presence + geometry + container duration, without decoding.
    Returns a dict or None on failure (silent; the loud open decides)."""
    lib = load()
    if lib is None:
        return None
    req = _make_req(path, **kwargs)
    res = Res()
    if lib.psxn_probe(ctypes.byref(req), ctypes.byref(res)) != 0:
        return None
    return _meta_dict(res)


class IngestStream:
    """Bounded-memory native decode stream (psxn_stream_*)."""

    def __init__(self, path, **kwargs):
        lib = load()
        assert lib is not None
        self._lib = lib
        req = _make_req(path, **kwargs)
        res = Res()
        err = ctypes.c_int(0)
        self._h = lib.psxn_stream_open(ctypes.byref(req),
                                       ctypes.byref(res), ctypes.byref(err))
        if not self._h:
            raise OSError(err.value, "native ingest failed")
        self.meta = _meta_dict(res)
        w, h = res.video_width, res.video_height
        self._frame_size = w * h * 3 // 2

    def fill(self, min_audio_values=0, min_video_frames=0):
        """Decode until at least this much is buffered (or EOF).
        Returns True when EOF has been reached."""
        return bool(self._lib.psxn_stream_fill(
            self._h, int(min_audio_values), int(min_video_frames)))

    def buffered(self):
        a = ctypes.c_longlong(0)
        v = ctypes.c_longlong(0)
        self._lib.psxn_stream_buffered(self._h, ctypes.byref(a),
                                       ctypes.byref(v))
        return int(a.value), int(v.value)

    def take_audio(self, max_values):
        out = np.empty(int(max_values), np.int16)
        got = self._lib.psxn_stream_take_audio(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            int(max_values))
        return out[:got]

    def take_video(self, max_frames):
        """(n, frame_size) uint8 NV21 frames, n <= max_frames."""
        out = np.empty((int(max_frames), self._frame_size), np.uint8)
        got = self._lib.psxn_stream_take_video(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(max_frames))
        return out[:got]

    def close(self):
        if self._h:
            self._lib.psxn_stream_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
