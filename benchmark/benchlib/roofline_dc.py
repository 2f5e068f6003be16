"""K2's work (the v3/v3dc DC chain, ``dc_chain_kernel``) for its roofline
share, frozen here from the program's ``utils/roofline.py`` beside
``benchlib/roofline.py``, which holds the card's peaks and the other
kernels' counts: the (B, NB) int32 quantized DCs read, the DC bits and
codes written, and 12 operations a block (difference, wrap, size, code).

``tests/test_benchmark_str_v3_noise.py`` holds ``dc_work`` to the
program's function of the same name."""

from .roofline import I32

OPS_DC_BLOCK = 12


def dc_work(batch, nb):
    """K2 over ``batch`` frames of ``nb`` blocks: (bytes, operations)."""
    return 3 * batch * nb * I32, batch * nb * OPS_DC_BLOCK
