"""The port's copied tables and Huffman closed forms equal the JAX
module's, exhaustively; the CUDA header carries the same tables."""

import pathlib
import re

import numpy as np
import torch

import jax.numpy as jnp

from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu_torch.ops import bs as tbs

from test_torch_parity import assert_same, run_both

HEADER = (pathlib.Path(tbs.__file__).resolve().parent.parent / "csrc"
          / "bs_common.cuh")


def test_tables_equal_jax():
    assert np.array_equal(tbs.QUANT_PSX, jbs.QUANT_PSX)
    assert np.array_equal(tbs.ZAGZIG, jbs.ZAGZIG)
    for name in ("_ACC_W1", "_ACC_W2", "_ACC_W37", "_ACC_W8", "_ACBC_W1",
                 "_ACBC_W2", "_ACBC_W37", "_ESC10"):
        assert getattr(tbs, name) == getattr(jbs, name), name
    assert (tbs.BS_V2, tbs.BS_V3, tbs.BS_V3DC) == (jbs.BS_V2, jbs.BS_V3,
                                                   jbs.BS_V3DC)


def _header_array(name):
    text = HEADER.read_text()
    m = re.search(name + r"(?:\[\d+\])?\s*=\s*\{?([^;}]*)\}?;", text)
    assert m, name
    return [int(v, 0) for v in m.group(1).replace("\n", " ").split(",")
            if v.strip()]


def test_cuda_header_tables():
    """The kernels' constant tables equal the port's Python tables."""
    assert _header_array("kQuantZZ") == list(tbs.QUANT_ZZ)
    inv = [-1] * 64
    for p in range(1, 64):
        inv[int(tbs.ZAGZIG[p])] = p - 1
    assert _header_array("kZigzagRow") == inv
    assert tuple(_header_array("kAcbcW1")) == tbs._ACBC_W1
    assert tuple(_header_array("kAcbcW2")) == tbs._ACBC_W2
    assert tuple(_header_array("kAcbcW37")) == tbs._ACBC_W37
    assert tuple(_header_array("kAccW8")) == tbs._ACC_W8
    assert _header_array("kEsc10") == [tbs._ESC10]


def _ac_grid():
    run, lev = np.meshgrid(np.arange(63), np.arange(1, 0x201), indexing="ij")
    run = np.concatenate([run.ravel(), run.ravel()]).astype(np.int32)
    ac = np.concatenate([lev.ravel(), -lev.ravel()]).astype(np.int32)
    return run, ac


def test_ac_closed_forms_exhaustive():
    """Every (run 0..62, level +-1..0x200): bits, fused (bits, code) and
    code equal JAX's closed forms and the reference LUTs."""
    run, ac = _ac_grid()
    mag = np.abs(ac)
    bits, _ = run_both(jbs.ac_bits_closed_form, tbs.ac_bits_closed_form,
                       run, mag)
    run_both(jbs.ac_bits_code_closed_form, tbs.ac_bits_code_closed_form,
             run, ac, u32=True)
    run_both(jbs.ac_code_closed_form, tbs.ac_code_closed_form, run, ac,
             np.asarray(bits[0]), u32=True)
    key = (run << 10) | (ac & 0x3FF)
    got_b, got_c = tbs.ac_bits_code_closed_form(torch.from_numpy(run),
                                                torch.from_numpy(ac))
    assert_same(jbs.AC_BITS_LUT[key], got_b)
    assert_same(jbs.AC_CODE_LUT[key], got_c, u32=True)


def test_dc_closed_form_exhaustive():
    """Every (type, 9-bit key), incl. the unmapped delta -256."""
    types, keys = np.meshgrid(np.arange(3), np.arange(512), indexing="ij")
    types = types.ravel().astype(np.int32)
    keys = keys.ravel().astype(np.int32)
    run_both(jbs.dc_bits_code_closed_form, tbs.dc_bits_code_closed_form,
             types, keys, u32=True)
    got_b, got_c = tbs.dc_bits_code_closed_form(torch.from_numpy(types),
                                                torch.from_numpy(keys))
    assert_same(jbs.DC_BITS_LUT[types, keys], got_b)
    assert_same(jbs.DC_CODE_LUT[types, keys], got_c, u32=True)


def test_quantizer_arithmetic():
    """_div_rounded, _div_rounded_fast and _clamp_coeff equal JAX's over
    the operating range (int16 coefficients, every quant divisor)."""
    rng = np.random.default_rng(0)
    n = np.concatenate([np.arange(-32768, 32768, 97),
                        rng.integers(-32768, 32768, 5000)]).astype(np.int32)
    divisors = sorted({int(q) * s for q in jbs.QUANT_PSX
                       for s in range(1, 64)} | {16})
    nt = torch.from_numpy(n)
    for d in divisors[::7] + [divisors[0], divisors[-1]]:
        want = np.asarray(jbs._div_rounded(jnp.asarray(n), jnp.int32(d)))
        dt = torch.tensor(d, dtype=torch.int32)
        assert_same(want, tbs._div_rounded(nt, d), name=str(d))
        assert_same(want, tbs._div_rounded_fast(nt, dt), name=str(d))
    q = np.arange(-70000, 70000, 7, dtype=np.int32)
    run_both(jbs._clamp_coeff, tbs._clamp_coeff, q)
