"""psxavenc_tpu_torch — the PlayStation A/V encoder on PyTorch and CUDA.

A second implementation of ``psxavenc_tpu`` for one NVIDIA Hopper card:
XA-ADPCM and SPU-ADPCM audio, BS v2/v3/v3dc video and every container of
the argv-compatible CLI. The module names mirror the JAX package so each
piece has an obvious counterpart:

- ``ops/``        — plain-torch ops (FDCT, Huffman closed forms, bit
                    packing, the ADPCM unit search) and the wrappers of the
                    hand-written CUDA kernels (``ops/bs_cuda.py``,
                    ``ops/bitpack_cuda.py``, ``ops/adpcm_cuda.py``, sources
                    in ``csrc/``, built by ``ops/_build.py``).
- ``api.py``      — the batch tensor API: ADPCM unit streams and
                    ``bs_encode_frames_packed``.
- ``models/``     — ``BsFrameEncoder`` (chunked frame batches, the next
                    one's upload, step and read-back enqueued on the
                    encoder's CUDA stream before this one's event is
                    waited on, + headers) and the ADPCM stream layer; on a
                    CPU device both take the native C++ tiers
                    (``native/tiers.py``) unless PSXAVENC_VIDEO_TIER=device
                    or PSXAVENC_NO_NATIVE_ADPCM is set.
- ``parallel/``   — ``mesh.py``: the batch axis split over a list of
                    devices (``packed_video_step``, ``unit_encode_step``,
                    ``encode_step_sharded``).
- ``containers/`` — the .xa/.xacd, .spu/.vag/.spui/.vagi, .str and .sbs
                    muxers.
- ``cli.py``      — ``python -m psxavenc_tpu_torch.cli``, argv-compatible
                    with ``psxavenc_tpu.cli``.
- ``cli_args.py``, ``io/``, ``utils/``, ``native/``, ``data/`` — the
                    argument parser, the ingest (with its FFmpeg extension),
                    progress lines, synthetic media, the H100's speed of
                    light (``utils/roofline.py``), the host CD-sector
                    code and the native encoder tiers: the package's own
                    copies of the JAX package's framework-free modules;
                    the C++ builds with g++ into ``build/``.

Every function takes its device from its tensors or an explicit
``device`` argument (a list of devices where a batch splits over them);
there is no global device state. The package imports
``torch`` and never ``jax``, and nothing of ``psxavenc_tpu``.
"""

__version__ = "0.1.0"
