"""Speed-of-light accounting on the H100: the card's peaks, the operations
the port's kernels do per element, and the bounds they give.

Counterpart of ``psxavenc_tpu/utils/roofline.py``, counted off the
port's CUDA kernels (``csrc/``) instead of the TPU's vector unit. The
least time the card could take for a piece of work is the larger of its
bytes (each input read once, each output written once) over the card's
memory rate and its integer operations over the SMs' int32 rate.
``chip_smoke.py`` prints every kernel's bound from here, and a benchmark
shares the same copy.

The per-element counts are read from the kernels' code (a quantize, a
compare, a shift, a table lookup: one operation each); they are estimates
of the instruction stream, not counts of the compiled SASS.
"""

# ---- the card -------------------------------------------------------------
# NVIDIA H100 SXM (80GB HBM3): 3.35 TB/s of HBM3 (NVIDIA's data sheet). The
# data sheet gives no int32 rate outside the tensor cores; the Hopper white
# paper gives 64 INT32 lanes per SM, so 132 SMs x 64 x the 1.98 GHz boost
# clock. Both assume the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CHIPS = {
    "h100_sxm": {"int32_ops": INT32_OPS_PER_S, "hbm_bytes": HBM_BYTES_PER_S},
}


def chip_for(name):
    """The CHIPS entry of a card named as ``torch.cuda.get_device_name`` or
    ``nvidia-smi --query-gpu=name`` print it; raises for any other card
    (the H100's PCIe and NVL parts have other rates)."""
    if "H100" in name and "HBM3" in name:
        return CHIPS["h100_sxm"]
    raise ValueError(f"no speed-of-light figures for the card {name!r}")


# ---- operations per element, counted from the kernels' code ----------------
OPS_FDCT_BLOCK = 900      # K1: two 8x8 islow passes + descale + zigzag
OPS_SCALE_EVAL = 20       # K1: quantize, run, closed-form bits, per coef
OPS_DC_BLOCK = 12         # K2: difference, wrap, size, code
OPS_EMIT_ZERO = 2         # K3, K7: the zero test of a coefficient (compare
                          #     with half the divisor, OR into the mask)
OPS_EMIT_NONZERO = 50     # K3, K7: per nonzero level: quantize and clamp,
                          #     run, code lookup or escape, shift into words
OPS_EMIT_BLOCK = 60       # K3, K7: DC and EOB codes, the offset's scan,
                          #     nine shifted and paired words (16 for K7)
OPS_TAIL_BLOCK = 2        # tail emission: a block's total read and compared
OPS_PLACE_WORD = 4        # K4, K8, K9: test, offset, bound check, OR
OPS_FUNNEL_WORD = 6       # K9: shift, carry shift, mask, OR, LE pairing
OPS_PACK_SYMBOL = 24      # K10: length mask, window index and shifts,
                          #     two-window OR, per symbol slot
OPS_ADPCM_STEP = 20       # K5: predict, quantize, clip, decode, error,
                          #     pack, per candidate and sample
OPS_ADPCM_RESID = 8       # K5: residual and extrema, per filter, sample


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, chip=CHIPS["h100_sxm"]):
    """(bound ms, what bounds it: "bytes" or "operations")."""
    ms_bytes = n_bytes / chip["hbm_bytes"] * 1e3
    ms_ops = ops / chip["int32_ops"] * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                            "operations")


def _nonzero(coefs, scale, nb):
    """(B, 63, nb) mask of the AC levels that are nonzero at each frame's
    scale."""
    from ..ops import bs as bs_ops

    d = bs_ops.quant_zz(coefs.device)[None, :, None] * scale[:, None, None]
    return coefs[:, :63, :nb].abs() >= (d + 1) >> 1


def emit_ops(coefs, scale, nb, blocks=None):
    """The operations of the emission (K3, K7; the tail emission on the
    (B, NB) mask ``blocks``) on this run's data: a zero test for every
    coefficient, the quantize-and-code work for those whose level at the
    frame's scale is nonzero, counted here, and the per-block work."""
    nonzero = _nonzero(coefs, scale, nb)
    n_blocks = coefs.shape[0] * nb
    if blocks is not None:
        nonzero = nonzero & blocks[:, None, :]
        n_blocks = int(blocks.sum())
    return (n_blocks * (63 * OPS_EMIT_ZERO + OPS_EMIT_BLOCK)
            + int(nonzero.sum()) * OPS_EMIT_NONZERO)


def nonzero_share(coefs, scale, nb):
    """The share of the AC levels that are nonzero at their frame's scale
    (``video_census``'s density)."""
    return int(_nonzero(coefs, scale, nb).sum()) / (coefs.shape[0] * 63 * nb)


def adpcm_ops(n_units, filter_count):
    """K5's operations on ``n_units`` units of 28 samples."""
    return n_units * 28 * (3 * filter_count * OPS_ADPCM_STEP
                           + filter_count * OPS_ADPCM_RESID)


# ---- the JAX module's API ---------------------------------------------------

def audio_kernel_census(filter_count=5, shift_range=12):
    """int32 operations per encoded sample of K5 (``csrc/adpcm_units.cu``):
    three candidates a filter through the 28-step recurrence, and the
    residual and extrema pass a filter. The shift search is folded into
    the candidates, so the count does not depend on ``shift_range``."""
    del shift_range
    return adpcm_ops(1, filter_count) / 28


def audio_roofline_msps(chip, filter_count=5, shift_range=12):
    """Speed-of-light Msamples/s of K5 on ``chip`` (its operations bound
    it: a sample moves about 5 bytes)."""
    return chip["int32_ops"] / audio_kernel_census(filter_count,
                                                   shift_range) / 1e6


# K3's default nonzero density: the share of AC coefficients with a
# nonzero level at their frame's scale in the first 16 frames of
# chip_smoke.py's phase 6 video mix (BS v2 320x240, 18,144-byte budgets),
# to four places; tests/test_torch_roofline.py computes it on the CPU.
NONZERO_DENSITY = 0.2081
EVALS_PER_FRAME = 2       # K1: the exact totals at the chosen scale and
                          #     the one below it


def video_census(width=320, height=240, batch=128, capacity_words=9068,
                 codec=0, nonzero_density=NONZERO_DENSITY):
    """Per-stage {ops, bytes} of the main path's kernels on a
    ``batch``-frame step (``api.bs_encode_frames_packed``, ``fused_mxu``):
    K1 (FDCT + scale search), K2 (the DC chain, v3/v3dc only), K3
    (emission + placement prep, at ``nonzero_density`` nonzero AC levels),
    K4 (placement) and the tail emission (its test of every block; the
    blocks over 256 bits are not counted). Shapes are the kernels' own:
    int8 pixel rows in, int16 coefficients padded to ``nb_pad`` blocks,
    nine u32 words and an offset a block (and the EOF block)."""
    nb = (width // 16) * (height // 16) * 6
    nb_pad = -(-nb // 512) * 512              # ops.bs_cuda.nb_padded
    i32 = 4
    cap32 = (capacity_words + 1) // 2
    coefs = batch * 64 * nb_pad * 2
    dc = batch * nb * i32
    vals = batch * (nb + 1) * 9 * i32
    e0 = batch * (nb + 1) * i32
    stages = {
        "K1": {"ops": nb * (batch * OPS_FDCT_BLOCK
                            + 63 * OPS_SCALE_EVAL * EVALS_PER_FRAME * batch),
               "bytes": batch * 64 * nb + batch * i32 + 3 * batch * i32
               + coefs},
    }
    if codec != 0:
        stages["K2"] = {"ops": batch * nb * OPS_DC_BLOCK, "bytes": 3 * dc}
    stages["K3"] = {
        "ops": batch * nb * (63 * OPS_EMIT_ZERO + OPS_EMIT_BLOCK)
        + nonzero_density * 63 * batch * nb * OPS_EMIT_NONZERO,
        "bytes": coefs + batch * i32 + 2 * dc + vals + e0 + dc
        + batch * i32}
    stages["K4"] = {"ops": batch * (nb + 1) * 9 * OPS_PLACE_WORD,
                    "bytes": vals + e0 + batch * cap32 * i32}
    stages["tail"] = {"ops": batch * nb * OPS_TAIL_BLOCK,
                      "bytes": dc + batch * i32}
    return stages


def speed_of_light_s(census, chip):
    """Sequential-stage light-speed seconds: the sum over stages of
    max(op-bound, byte-bound)."""
    return sum(max(st["ops"] / chip["int32_ops"],
                   st["bytes"] / chip["hbm_bytes"])
               for st in census.values())


def video_report(achieved_ms_per_batch, chip, width=320, height=240,
                 batch=128, capacity_words=9068, codec=0,
                 nonzero_density=NONZERO_DENSITY):
    """-> (sol_ms, pct_of_roofline) for the main path's kernels."""
    sol = speed_of_light_s(
        video_census(width, height, batch, capacity_words, codec,
                     nonzero_density), chip) * 1e3
    return sol, 100.0 * sol / achieved_ms_per_batch


def audio_report(achieved_msps, chip, filter_count=5, shift_range=12):
    """-> (sol_msps, pct_of_roofline) for K5."""
    sol = audio_roofline_msps(chip, filter_count, shift_range)
    return sol, 100.0 * achieved_msps / sol
