"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ctypes. The library is built at first use into
``psxavenc_tpu_torch/build/`` (ignored by git) and named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
A missing ``nvcc`` or a failed build raises; nothing falls back to the
plain versions.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("bs_nv21.cu", "bs_select.cu", "bs_dc.cu", "bs_emit.cu",
           "bitpack_place.cu", "bitpack_gather.cu", "bitpack_streams.cu",
           "adpcm_units.cu")
HEADERS = ("bs_common.cuh", "ac_codes.cuh", "place_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures: every pointer and the stream as c_void_p.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "psx_nv21_pix_dc": [_P, _I, _I, _I, _P, _P, _P],
    "psx_select_scale_pix": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P],
    "psx_dc_stage": [_P, _I, _I, _I, _P, _P, _P],
    "psx_empty_launch": [_I, _I, _P],
    "psx_emit_prep": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                      _P],
    "psx_place_vals": [_P, _P, _I, _I, _I, _I, _P, _P],
    "psx_place_vals_gather": [_P, _P, _I, _I, _I, _I, _P, _P],
    "psx_select_scale": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "psx_select_constants": [_P],
    "psx_emit_pack": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "psx_emit_tail": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                      _P],
    "psx_place_streams": [_P, _P, _I, _I, _I, _I, _P, _P],
    "psx_pack_block_streams": [_P, _P, _I, _I, _P, _P, _P, _I, _P],
    "psx_adpcm_encode_pcm_units": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                   _P, _P, _P],
}

_lib = None
# The compiler's output (ptxas register/spill report), kept beside the
# library so that a later process can read it too.
build_log = ""


def find_nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "psxavenc_tpu_torch need the CUDA toolkit")


def build():
    """Compile the kernels (if not built yet); returns the library path.

    Each source compiles in its own nvcc process, all started together;
    one more nvcc links the objects."""
    global build_log
    nvcc = find_nvcc()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    out = BUILD_DIR / f"libpsx_torch_kernels_{h.hexdigest()[:16]}.so"
    log_file = out.with_suffix(".log")
    if out.exists():
        if log_file.exists():
            build_log = log_file.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [pathlib.Path(td) / f"{s}.o" for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [f"== {s}\n{p.communicate()[0]}"
                for s, p in zip(SOURCES, procs)]
        build_log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               f"{build_log}")
        tmp = pathlib.Path(td) / out.name
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        log_file.write_text(build_log)
        os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name, tensor, *args):
    """Call kernel entry point ``name`` with ``args`` and the current
    stream of ``tensor``'s device (made the current device for the call);
    raises if the launch reported a CUDA error."""
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        rc = getattr(lib(), name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())
