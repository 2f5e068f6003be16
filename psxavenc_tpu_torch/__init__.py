"""psxavenc_tpu_torch — the BS video encoder on PyTorch and CUDA.

A second implementation of ``psxavenc_tpu``'s main path, BS v2/v3/v3dc
frame encode (NV21 frames + per-frame byte budgets -> packed MDEC
bitstream), for one NVIDIA Hopper card. The module names mirror the JAX
package so each piece has an obvious counterpart:

- ``ops/``        — plain-torch ops (FDCT, Huffman closed forms, bit
                    packing) and the wrappers of the hand-written CUDA
                    kernels (``ops/bs_cuda.py``, ``ops/bitpack_cuda.py``,
                    sources in ``csrc/``, built by ``ops/_build.py``).
- ``api.py``      — ``bs_encode_frames_packed``: pixels in, packed words
                    out.
- ``models/``     — ``BsFrameEncoder``: chunked batches + frame headers.
- ``containers/`` — the ``.sbs`` and ``.str`` (``-t strv``) muxers.
- ``cli.py``      — ``python -m psxavenc_tpu_torch.cli``, argv-compatible
                    with ``psxavenc_tpu.cli`` for the ported formats.

Every function takes its device from its tensors or an explicit
``device`` argument; there is no global device state. The package imports
``torch`` and never ``jax``; of the JAX package it reuses only the
framework-free modules (``cli_args``, ``io``, ``native``,
``utils.progress``, ``utils.synth``).
"""

__version__ = "0.1.0"
