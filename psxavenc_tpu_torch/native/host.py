"""ctypes loader for the host sector code (psxav_host.cpp).

The shared object is compiled with g++ at first use into the package's
``build/`` directory (ignored by git), named by a hash of the source and
flags. This is host code, as in psxavenc_tpu: CD sector framing, EDC and
XA payload assembly work on one 2,352-byte sector at a time.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "psxav_host.cpp"
_BUILD_DIR = _DIR.parent / "build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

SECTOR_MODE1 = 0
SECTOR_MODE2_FORM1 = 1
SECTOR_MODE2_FORM2 = 2

_lib = None


def _build():
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libpsxav_host_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp = pathlib.Path(td) / out.name
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def lib():
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        handle.psxh_edc.restype = ctypes.c_uint32
        handle.psxh_edc.argtypes = [ctypes.c_char_p, ctypes.c_long]
        handle.psxh_edc_batch.restype = None
        handle.psxh_edc_batch.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_long] * 5
        handle.psxh_sector_init.restype = None
        handle.psxh_sector_init.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
        handle.psxh_calc_checksums.restype = None
        handle.psxh_calc_checksums.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
        handle.psxh_xa_assemble.restype = None
        handle.psxh_xa_assemble.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int]
        _lib = handle
    return _lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _check_u8(arr, min_size):
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous \
            or arr.size < min_size:
        raise ValueError(f"expected a C-contiguous uint8 array of at least "
                         f"{min_size} bytes")


def edc(data):
    data = bytes(data)
    return lib().psxh_edc(data, len(data))


def edc_batch(sectors, crc_off, crc_len, edc_off):
    """In-place EDC for an (n, stride) uint8 sector array."""
    _check_u8(sectors, 0)
    n, stride = sectors.shape
    if not (0 <= crc_off and crc_off + crc_len <= stride
            and 0 <= edc_off <= stride - 4):
        raise ValueError("edc_batch: offsets outside the sector stride")
    lib().psxh_edc_batch(_ptr(sectors), n, stride, crc_off, crc_len,
                         edc_off)


def sector_init(sector, lba, stype):
    _check_u8(sector, 24)
    lib().psxh_sector_init(_ptr(sector), lba, stype)


def calc_checksums(sector, stype):
    _check_u8(sector, 0x930)
    lib().psxh_calc_checksums(_ptr(sector), stype)


def xa_assemble(headers, nibbles, units_per_block, bits8):
    """(18, upb) headers + (18, upb, 28) sample values -> 2304-byte
    payload."""
    headers = np.ascontiguousarray(headers, dtype=np.uint8)
    nibbles = np.ascontiguousarray(nibbles, dtype=np.uint8)
    if headers.size != 18 * units_per_block \
            or nibbles.size != 18 * units_per_block * 28:
        raise ValueError("xa_assemble: expected (18, upb) headers and "
                         "(18, upb, 28) sample values")
    payload = np.zeros(2304, dtype=np.uint8)
    lib().psxh_xa_assemble(_ptr(payload), _ptr(headers), _ptr(nibbles),
                           units_per_block, int(bits8))
    return payload
