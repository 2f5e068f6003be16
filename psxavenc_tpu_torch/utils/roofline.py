"""Speed-of-light accounting on the H100: the card's peaks, the operations
the port's kernels do per element, and the bounds they give.

Counterpart of ``psxavenc_tpu/utils/roofline.py``, counted off the
port's CUDA kernels (``csrc/``) instead of the TPU's vector unit. The
least time the card could take for a piece of work is the larger of its
bytes (each input read once, each output written once) over the card's
memory rate and its integer operations over the SMs' int32 rate.
Each kernel's bytes and operations are one ``*_work`` function here, of
the kernel's shapes and of the counts that this run's data sets;
``chip_smoke.py``, ``tools/torch_kernel_bench.py`` and
``tools/torch_lint_docs.py`` (``PERF.md``'s kernel table) all call them.

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


def nonzero_count(coefs, scale, nb, blocks=None):
    """The AC levels of ``coefs`` nonzero at each frame's ``scale``, in
    the blocks of the (B, NB) mask ``blocks`` where given."""
    nonzero = _nonzero(coefs, scale, nb)
    if blocks is not None:
        nonzero = nonzero & blocks[:, None, :]
    return int(nonzero.sum())


def emit_block_ops(n_blocks, n_nonzero):
    """The emission's operations (K3, K7, the tail emission's long
    blocks): a zero test for every coefficient of ``n_blocks`` blocks, the
    per-block work, and the quantize-and-code work of ``n_nonzero``
    nonzero levels."""
    return (n_blocks * (63 * OPS_EMIT_ZERO + OPS_EMIT_BLOCK)
            + n_nonzero * OPS_EMIT_NONZERO)


def nonzero_share(coefs, scale, nb):
    """The share of the AC levels that are nonzero at their frame's scale
    (``video_census``'s density)."""
    return nonzero_count(coefs, scale, nb) / (coefs.shape[0] * 63 * nb)


def adpcm_ops(n_units, filter_count):
    """K5's operations on ``n_units`` units of 28 samples."""
    return n_units * 28 * (3 * filter_count * OPS_ADPCM_STEP
                           + filter_count * OPS_ADPCM_RESID)


# ---- each kernel's work: (bytes, operations) --------------------------------
# Bytes are each input read once and each output written once, at the
# wrappers' dtypes: int8 pixel rows, int16 (B, 64, nb_pad) or int32 (B, 63,
# NB) coefficients, int32 everything else. ``batch`` frames of ``nb``
# blocks; ``nbe`` = nb + 1 with the end-of-frame block.
I32 = 4


def fdct_select_work(batch, nb, nb_pad, evals):
    """K1: pixel rows and thresholds in; scale, AC bits, nonzero count
    and the int16 coefficients out. ``evals``: the scale evaluations the
    frames need (two a frame, one for scale 1 and unfittable frames)."""
    return (batch * 64 * nb + batch * I32 + 3 * batch * I32
            + batch * 64 * nb_pad * 2,
            nb * (batch * OPS_FDCT_BLOCK + 63 * OPS_SCALE_EVAL * evals))


def select_work(batch, nb, evals):
    """K6: int32 (B, 63, NB) coefficients and thresholds in; scale, AC
    bits and nonzero count out."""
    return (batch * 63 * nb * I32 + batch * I32 + 3 * batch * I32,
            nb * 63 * OPS_SCALE_EVAL * evals)


def dc_work(batch, nb):
    """K2: the quantized DCs in, DC bits and codes out."""
    return 3 * batch * nb * I32, batch * nb * OPS_DC_BLOCK


def emit_prep_work(batch, nb, coef_bytes, n_nonzero):
    """K3: coefficients (``coef_bytes``), scales, DC codes and bits in;
    nine placement words and an offset a block (and the EOF block), the
    block totals and the frame totals out."""
    nbe = nb + 1
    return (coef_bytes + batch * I32 + 2 * batch * nb * I32
            + batch * nbe * 9 * I32 + batch * nbe * I32
            + batch * nb * I32 + batch * I32,
            emit_block_ops(batch * nb, n_nonzero))


def emit_pack_work(batch, nb, coef_bytes, n_nonzero):
    """K7: K3's inputs; 16 stream words and the total a block out."""
    return (coef_bytes + batch * I32 + 2 * batch * nb * I32
            + batch * nb * 16 * I32 + batch * nb * I32,
            emit_block_ops(batch * nb, n_nonzero))


def place_work(batch, nbe, out_words):
    """K4, K8: nine words and an offset a block in, ``out_words`` words a
    frame out."""
    return (batch * nbe * 9 * I32 + batch * nbe * I32
            + batch * out_words * I32,
            batch * nbe * 9 * OPS_PLACE_WORD)


def place_streams_work(batch, nbe, out_words):
    """K9: 16 stream words and an offset a block in, ``out_words`` words a
    frame out."""
    return (batch * nbe * 16 * I32 + batch * nbe * I32
            + batch * out_words * I32,
            batch * nbe * (16 * OPS_FUNNEL_WORD + 9 * OPS_PLACE_WORD))


def pack_work(batch, nbe, slots):
    """K10: codes and bit lengths of ``slots`` symbols a block in, 16
    stream words and the total a block out."""
    return (2 * batch * nbe * slots * I32 + batch * nbe * 16 * I32
            + batch * nbe * I32,
            batch * nbe * slots * OPS_PACK_SYMBOL)


def tail_work(batch, nb, n_long=0, long_nonzero=0, coef_size=2,
              tail_bytes=0):
    """The tail emission: every block's total and the frames' scales read
    and tested; for each of the ``n_long`` blocks over 256 bits, its
    column of coefficients (``coef_size`` bytes each), its DC code and
    bits and the emission of its ``long_nonzero`` nonzero levels; the
    ``tail_bytes`` past the window and each long block's two boundary
    words read and written."""
    return (batch * nb * I32 + batch * I32
            + n_long * (63 * coef_size + 8)
            + 2 * (tail_bytes + 8 * n_long),
            batch * nb * OPS_TAIL_BLOCK + emit_block_ops(n_long,
                                                         long_nonzero))


def adpcm_work(streams, units, filter_count, words):
    """K5: 28 samples and a limit a unit and two states a stream in; the
    header, ``words`` packed words and two states a unit out."""
    n = streams * units
    return (n * 28 * I32 + n * I32 + 2 * streams * I32
            + n * (3 + words) * I32,
            adpcm_ops(n, filter_count))


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
    cap32 = (capacity_words + 1) // 2
    work = {"K1": fdct_select_work(batch, nb, nb_pad,
                                   EVALS_PER_FRAME * batch)}
    if codec != 0:
        work["K2"] = dc_work(batch, nb)
    work["K3"] = emit_prep_work(batch, nb, batch * 64 * nb_pad * 2,
                                nonzero_density * 63 * batch * nb)
    work["K4"] = place_work(batch, nb + 1, cap32)
    work["tail"] = tail_work(batch, nb)
    return {k: {"ops": ops, "bytes": n_bytes}
            for k, (n_bytes, ops) in work.items()}


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
