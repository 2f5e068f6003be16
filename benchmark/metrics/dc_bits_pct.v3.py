"""dc_bits_pct.v3: the DCs' share of the bitstream's bits over the traced
window, 100 x dc_bits / frame_bits, from the program's counters (each
frame's DC bits and total bits, read back with the batch only while a
profile runs). None where the program has no such counters."""

from benchlib import spec


def read(ctx):
    try:
        c = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()[
            "counters"]
    except (ImportError, AttributeError):
        return None
    total = c.get("frame_bits", 0)
    return 100.0 * c["dc_bits"] / total if total and "dc_bits" in c \
        else None
