"""K10's decomposition proven on the CPU: the warp-per-block packing
(ops/bitpack_cuda.py::pack_block_streams_lanes_plain, the plain model of
csrc/bitpack_streams.cu's pack_kernel: a shuffle scan of the bit lengths,
two windows a symbol, an OR over the lanes) equals the Pallas kernel in
interpret mode and the port's plain version, on codes with their top bit
set or garbage above their length, 0-bit symbols between others, blocks of
exactly 256 and 257 bits and far over (cut), all-zero rows, for S = 65, 17
and 130, on row counts that are no multiple of the kernel's tile."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda

from test_torch_parity import assert_same
from torch_dc_pack_cases import PACK_CASES, PACK_SYMBOLS, pack_case

B, NBE = 3, 37   # 111 rows: no multiple of 4, nor of the 32-row tile


@pytest.mark.parametrize("nsym", PACK_SYMBOLS)
@pytest.mark.parametrize("case", PACK_CASES)
def test_lane_model_matches_pallas(case, nsym):
    codes, bits = pack_case(case, B, NBE, nsym)
    want = jbpk.pack_block_streams_pallas(
        jnp.asarray(codes.astype(np.uint32)), jnp.asarray(bits),
        interpret=True)
    c, b = torch.from_numpy(codes), torch.from_numpy(bits)
    plain = bitpack_cuda.pack_block_streams_plain(c, b)
    got = bitpack_cuda.pack_block_streams_lanes_plain(c, b)
    for name, w, p, g in zip(("streams", "block bits"), want, plain, got):
        assert_same(w, p, name=f"plain {name}", u32=True)
        assert_same(w, g, name=f"lanes {name}", u32=True)


@pytest.mark.parametrize("codes_dtype", [torch.int64, torch.int32])
def test_lane_model_takes_either_code_form(codes_dtype):
    """int64 u32 values and int32 bit patterns give the same streams."""
    codes, bits = pack_case("top bit", B, NBE, 65)
    c = torch.from_numpy(codes)
    if codes_dtype == torch.int32:
        c = tbp.u32_to_i32(c)
    want = bitpack_cuda.pack_block_streams_plain(torch.from_numpy(codes),
                                                 torch.from_numpy(bits))
    got = bitpack_cuda.pack_block_streams_lanes_plain(c,
                                                      torch.from_numpy(bits))
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_pack_cases_are_adversarial():
    """The cases do what their names say."""
    for nsym in PACK_SYMBOLS:
        codes, bits = pack_case("256, 257, far over, all zero", B, NBE, nsym)
        totals = bits.sum(axis=2).ravel()
        assert {256, 257, 32 * nsym, 0} <= set(totals.tolist())
        codes, bits = pack_case("0-bit symbols between", B, NBE, nsym)
        assert (bits == 0).mean() > 0.4 and (codes[bits == 0] != 0).all()
        codes, bits = pack_case("top bit", B, NBE, nsym)
        assert (codes >> 31 == 1).all() and (bits == 32).any()
        codes, bits = pack_case("garbage above the length", B, NBE, nsym)
        assert (codes >> bits.astype(np.int64) != 0).mean() > 0.9
