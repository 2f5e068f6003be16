"""ctypes loader for the native C++ tiers (psxav_native.cpp): the ADPCM
unit encoder, the BS frame encoder and the BS bit packer on the host.

Counterpart of ``psxavenc_tpu/native/__init__.py``'s encoder functions:
numpy in, numpy out, bit-exact with the card's kernels and their plain
versions. They are the port's CPU path (``models/bs_video.py`` and
``models/adpcm_stream.py`` take them on a CPU device unless
PSXAVENC_VIDEO_TIER=device or PSXAVENC_NO_NATIVE_ADPCM says otherwise)
and an implementation independent of the kernels to hold the card's
output to.

The shared object is compiled with g++ at first use into the package's
``build/`` directory (ignored by git), named by a hash of the source, the
flags and, for ``-march=native``, what that means on this host (so that a
library built for another CPU is never loaded). The portable flag set is
tried when the first fails; when both fail, ``RuntimeError`` carries
g++'s messages. There is no fall-back to the device tier. ``COUNTERS``
counts the calls of each entry point.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "psxav_native.cpp"
_BUILD_DIR = _DIR.parent / "build"
COMPILER = "g++"
# -march=native vectorizes the integer hot loops (exact integer math, so
# the code generation cannot change a byte); -pthread for the frame
# encoder's and the unit encoder's host threads.
FLAG_SETS = (
    ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-march=native"),
    ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"),
)

COUNTERS = {"adpcm_encode_units": 0, "bs_encode_frames": 0, "bs_pack": 0}
_COUNT_LOCK = threading.Lock()

_lib = None


def _count(name):
    with _COUNT_LOCK:
        COUNTERS[name] += 1


def _target(flags):
    """g++'s resolved target options where ``flags`` ask for the host's
    CPU, else nothing."""
    if "-march=native" not in flags:
        return b""
    try:
        proc = subprocess.run(
            [COMPILER, "-march=native", "-Q", "--help=target"],
            capture_output=True)
    except OSError:
        return b""                  # the build itself reports it
    return proc.stdout if proc.returncode == 0 else b""


def _build():
    src = _SRC.read_bytes()
    errors = []
    for flags in FLAG_SETS:
        key = src + " ".join(flags).encode() + _target(flags)
        tag = hashlib.sha256(key).hexdigest()[:16]
        out = _BUILD_DIR / f"libpsxav_native_{tag}.so"
        if out.exists():
            return out
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
            tmp = pathlib.Path(td) / out.name
            try:
                proc = subprocess.run(
                    [COMPILER, *flags, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True)
            except OSError as e:
                errors.append(f"{COMPILER} {' '.join(flags)}: {e}")
                continue
            if proc.returncode == 0:
                os.replace(tmp, out)
                return out
            errors.append(f"{COMPILER} {' '.join(flags)}:\n{proc.stderr}")
    raise RuntimeError(f"{COMPILER} failed on {_SRC.name} with every flag "
                       "set:\n" + "\n".join(errors))


def lib():
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        handle.psxn_bs_pack.restype = ctypes.c_long
        handle.psxn_bs_pack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long]
        handle.psxn_adpcm_encode_units.restype = None
        handle.psxn_adpcm_encode_units.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        handle.psxn_bs_encode_frames.restype = None
        handle.psxn_bs_encode_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = handle
    return _lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def adpcm_encode_units(units, limits, prev1, prev2, filter_count,
                       shift_range):
    """Host ADPCM unit-stream encode.

    Arguments as ``ops/adpcm.py::encode_units_scan``'s: units (B, T, 28)
    (stored as int16), limits (B, T) (clipped to [-(1 << 30), 28]),
    prev1/prev2 (B,). Returns (headers (B, T) uint8, sample values (B, T,
    28) uint8, s1 (B, T) int32, s2 (B, T) int32), the decoder state after
    every unit; the B streams fan out over host threads."""
    if not (1 <= filter_count <= 5 and 1 <= shift_range <= 12):
        raise ValueError(f"filter_count {filter_count} (1-5) or shift_range "
                         f"{shift_range} (1-12) out of range")
    units = np.ascontiguousarray(units, dtype=np.int16)
    if units.ndim != 3 or units.shape[2] != 28:
        raise ValueError("units must be (B, T, 28)")
    B, T, _ = units.shape
    limits = np.ascontiguousarray(
        np.clip(limits, -(1 << 30), 28), dtype=np.int32)
    if limits.shape != (B, T):
        raise ValueError("limits must be (B, T)")
    state = np.ascontiguousarray(
        np.stack([np.asarray(prev1, np.int32),
                  np.asarray(prev2, np.int32)], axis=1))
    if state.shape != (B, 2):
        raise ValueError("prev1 and prev2 must be (B,)")
    headers = np.zeros((B, T), np.uint8)
    nibbles = np.zeros((B, T, 28), np.uint8)
    s1 = np.zeros((B, T), np.int32)
    s2 = np.zeros((B, T), np.int32)
    lib().psxn_adpcm_encode_units(
        _ptr(units), _ptr(limits), _ptr(state), _ptr(headers),
        _ptr(nibbles), _ptr(s1), _ptr(s2), B, T, filter_count,
        shift_range)
    _count("adpcm_encode_units")
    return headers, nibbles, s1, s2


def bs_encode_frames(frames, budgets, *, codec, width, height,
                     capacity_words, n_threads=None, seeds=None):
    """Host BS video frame encode.

    Arguments and outputs as ``api.bs_encode_frames_packed``'s: frames (B,
    w*h*3/2) uint8 NV21, budgets (B,) int32 byte budgets -> dict of numpy
    arrays {scale (B,), words (B, capacity_words) uint16, total_bits (B,),
    nz_count (B,)}; scale 64 = unfittable (the caller raises, mdec.c:723).
    Frames fan out over ``n_threads`` host threads (default: one a core,
    at most B).

    ``seeds``: optional (n_threads, 2) int32 in/out array carrying each
    worker's (answer scale, walk start) select seeds across calls, so that
    a chunked caller starts every chunk warm. Seeds only steer the order
    of the search; the selected scales and the bytes do not depend on
    them."""
    if width % 16 or height % 16 or width <= 0 or height <= 0:
        raise ValueError("frame geometry must be positive multiples of "
                         f"16, got {width}x{height}")
    if codec not in (0, 1, 2) or capacity_words < 1:
        raise ValueError(f"codec {codec} (0 v2, 1 v3, 2 v3dc) or "
                         f"capacity_words {capacity_words} out of range")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    B = frames.shape[0]
    if frames.ndim != 2 or frames.shape[1] != width * height * 3 // 2:
        raise ValueError("frames must be (B, w*h*3/2) NV21 bytes")
    budgets = np.ascontiguousarray(budgets, dtype=np.int32)
    if budgets.shape != (B,):
        raise ValueError("budgets must be (B,)")
    words = np.zeros((B, capacity_words), np.uint16)
    scale = np.zeros(B, np.int32)
    total_bits = np.zeros(B, np.int32)
    nz = np.zeros(B, np.int32)
    if n_threads is None:
        n_threads = min(B, os.cpu_count() or 1)
    if seeds is not None and (
            seeds.dtype != np.int32 or not seeds.flags.c_contiguous
            or seeds.shape != (int(n_threads), 2)):
        raise ValueError("seeds must be a C-contiguous int32 array of "
                         f"shape ({int(n_threads)}, 2)")
    lib().psxn_bs_encode_frames(
        _ptr(frames), _ptr(budgets), B, width, height, int(codec),
        capacity_words, int(n_threads), _ptr(words), _ptr(scale),
        _ptr(total_bits), _ptr(nz),
        _ptr(seeds) if seeds is not None else None)
    _count("bs_encode_frames")
    return {"scale": scale, "words": words, "total_bits": total_bits,
            "nz_count": nz}


def bs_pack(codes, lens, out_size):
    """Pack a BS symbol stream; returns (bytes_used, buffer) or (-1, None)
    when the frame exceeds out_size."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    lens = np.ascontiguousarray(lens, dtype=np.uint8)
    if codes.shape != lens.shape or codes.ndim != 1:
        raise ValueError("codes and lens must be (n,)")
    out = np.zeros(out_size, dtype=np.uint8)
    used = lib().psxn_bs_pack(_ptr(codes), _ptr(lens), len(codes),
                              _ptr(out), out_size)
    _count("bs_pack")
    if used < 0:
        return -1, None
    return used, out
