"""The yardstick of the roofline shares: the H100's peaks and the bytes
and operations of the port's kernels, frozen here from the program's
``utils/roofline.py`` so that a later change to the program cannot move
them. A bound is the larger of bytes over the memory rate and operations
over the int32 rate; the counts come from the work the algorithm needs
for the cell's shapes and the window's own data (frames, blocks, nonzero
levels at the chosen scale, units and filters), never from what an
implementation reports about itself.

``tests/test_benchmark_roofline.py`` holds each function here to the
program's function of the same name on the same counts.
"""

# NVIDIA H100 SXM (80GB HBM3): 3.35 TB/s of HBM3 (data sheet); 132 SMs x 64
# int32 lanes x the 1.98 GHz boost clock (Hopper white paper). Both assume
# the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
I32 = 4

OPS_FDCT_BLOCK = 900
OPS_SCALE_EVAL = 20
OPS_EMIT_ZERO = 2
OPS_EMIT_NONZERO = 50
OPS_EMIT_BLOCK = 60
OPS_TAIL_BLOCK = 2
OPS_PLACE_WORD = 4
OPS_ADPCM_STEP = 20
OPS_ADPCM_RESID = 8


def bound_s(n_bytes, ops):
    """Least seconds for ``n_bytes`` and ``ops`` on the card."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def emit_block_ops(n_blocks, n_nonzero):
    return (n_blocks * (63 * OPS_EMIT_ZERO + OPS_EMIT_BLOCK)
            + n_nonzero * OPS_EMIT_NONZERO)


def adpcm_ops(n_units, filter_count):
    return n_units * 28 * (3 * filter_count * OPS_ADPCM_STEP
                           + filter_count * OPS_ADPCM_RESID)


def fdct_select_work(batch, nb, nb_pad, evals):
    """K1 (FDCT and scale search): (bytes, operations)."""
    return (batch * 64 * nb + batch * I32 + 3 * batch * I32
            + batch * 64 * nb_pad * 2,
            nb * (batch * OPS_FDCT_BLOCK + 63 * OPS_SCALE_EVAL * evals))


def emit_prep_work(batch, nb, coef_bytes, n_nonzero):
    """K3 (emission and placement prep)."""
    nbe = nb + 1
    return (coef_bytes + batch * I32 + 2 * batch * nb * I32
            + batch * nbe * 9 * I32 + batch * nbe * I32
            + batch * nb * I32 + batch * I32,
            emit_block_ops(batch * nb, n_nonzero))


def place_work(batch, nbe, out_words):
    """K4 (placement)."""
    return (batch * nbe * 9 * I32 + batch * nbe * I32
            + batch * out_words * I32,
            batch * nbe * 9 * OPS_PLACE_WORD)


def tail_work(batch, nb, n_long=0, long_nonzero=0, coef_size=2,
              tail_bytes=0):
    """The tail emission (blocks over 256 bits)."""
    return (batch * nb * I32 + batch * I32
            + n_long * (63 * coef_size + 8)
            + 2 * (tail_bytes + 8 * n_long),
            batch * nb * OPS_TAIL_BLOCK + emit_block_ops(n_long,
                                                         long_nonzero))


def adpcm_work(streams, units, filter_count, words):
    """K5 (ADPCM units): ``units`` a stream."""
    n = streams * units
    return (n * 28 * I32 + n * I32 + 2 * streams * I32
            + n * (3 + words) * I32,
            adpcm_ops(n, filter_count))
