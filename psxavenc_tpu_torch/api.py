"""Batch tensor API: ADPCM unit streams and BS frames on one device.

Counterpart of ``psxavenc_tpu.api``:

- ``spu_encode_batch``, ``spu_encode_blocks``, ``xa_encode_batch``: B
  independent ADPCM unit streams, one K5 launch over all of them;
- ``bs_encode_frames``: the symbols API, NV21 frames -> FDCT
  coefficients (glue) -> scale selection (K6, or the plain sweep) ->
  (B, NB, 65) symbol tensors;
- ``bs_encode_frames_packed``: pixels in, packed bitstream words out,
  through any of psxavenc_tpu's packers (see its docstring for the
  kernels each runs). The default, ``fused_mxu`` with the kernel sweep,
  is the path psxavenc_tpu runs on its accelerator:

    NV21 -> pixel rows and quantized DCs (one kernel) -> DC stage (K2
    for v3/v3dc) -> AC fit threshold -> FDCT + scale search (K1) ->
    emission + placement prep (K3) -> placement (K4) -> the tail emission
    of blocks over 256 bits (which every ``fused*`` packer ends with);
- ``bs_encode_frames_owned``: that default step on frames its caller
  gives up, freed after the NV21 kernel (``BsFrameEncoder``'s step).

The device is the input tensors' device; on the CPU every kernel runs
its plain version. No step of that path on the card waits for the
device.
"""

import functools
import threading

import torch

from .ops import adpcm as adpcm_ops
from .ops import adpcm_cuda
from .ops import bitpack as bitpack_ops
from .ops import bitpack_cuda
from .ops import bs as bs_ops
from .ops import bs_cuda
from .ops import fdct as fdct_ops


class _Counters:
    """``COUNTERS["overflow_frames"]``: frames with a block over 256 bits
    that a fused packer met. The tail emission counts them on the frames'
    device, in one (1,) int32 tensor per card (its kernel adds with
    ``atomicAdd``, so batches on several streams or threads share it) and
    one per CPU thread (the plain version adds without atomics). Only the
    adds write those tensors: reading the entry brings what each has
    gained since the last read to the host, which is the only place where
    the counter waits for the device, so an add in flight on another
    stream or thread is never lost, only counted by a later read. Batches
    whose results were fetched are counted in full. Assigning to the entry
    discards what the devices counted before it."""

    def __init__(self):
        self._host = {"overflow_frames": 0}
        self._on_device = {}            # key -> (1,) int32 count
        self._seen = {}                 # key -> its value at the last read
        self._lock = threading.Lock()

    def device_count(self, device):
        """The (1,) int32 count on ``device`` that the tail emission adds
        to (on the CPU, the calling thread's)."""
        device = torch.device(device)
        key = device if device.type == "cuda" else (
            device, threading.get_ident())
        with self._lock:
            count = self._on_device.get(key)
            if count is None:
                count = torch.zeros((1,), dtype=torch.int32, device=device)
                if device.type == "cuda":
                    # Zeroed before a reader on another stream sees it;
                    # once per card and process.
                    torch.cuda.synchronize(device)
                self._on_device[key] = count
                self._seen[key] = 0
        return count

    def __iter__(self):
        return iter(self._host)

    def _gained(self):
        """What the device counts gained since the last read (int32 counts
        that wrap: the difference modulo 2**32)."""
        gained = 0
        for key, count in list(self._on_device.items()):
            value = int(count.item())
            gained += (value - self._seen[key]) % (1 << 32)
            self._seen[key] = value
        return gained

    def __getitem__(self, key):
        with self._lock:
            self._host[key] += self._gained()
            return self._host[key]

    def __setitem__(self, key, value):
        if key not in self._host:
            raise KeyError(key)
        with self._lock:
            self._gained()
            self._host[key] = value


COUNTERS = _Counters()


def _adpcm_words(units, limits, prev1, prev2, filter_count, shift_range):
    """K5 on the units as int16 samples (ValueError where one lies outside
    s16: ``adpcm_cuda.s16_units``) and int32 contiguous copies (where
    needed) of the limits and states."""
    args = [t.to(torch.int32).contiguous() for t in (limits, prev1, prev2)]
    return adpcm_cuda.encode_units(adpcm_cuda.s16_units(units).contiguous(),
                                   *args, filter_count=filter_count,
                                   shift_range=shift_range)


def _adpcm_batch(units, limits, prev1, prev2, filter_count, shift_range):
    h, words, s1, s2 = _adpcm_words(units, limits, prev1, prev2,
                                    filter_count, shift_range)
    return h, adpcm_cuda.unpack_words(words, shift_range), s1, s2


def spu_encode_batch(units, limits, prev1, prev2):
    """SPU-ADPCM: (B, T, 28) units of s16 samples (any integer dtype; a
    sample outside s16 raises ValueError), (B, T) int32 limits, (B,)
    int32 prev1/prev2 -> headers (B, T), sample values (B, T, 28) and the
    decoder state after each unit, s1 and s2 (B, T); int32 tensors."""
    return _adpcm_batch(units, limits, prev1, prev2,
                        adpcm_ops.SPU_FILTER_COUNT,
                        adpcm_ops.SHIFT_RANGE_4BPS)


def spu_encode_blocks(units, limits, prev1, prev2):
    """SPU-ADPCM straight to 16-byte blocks on the device, inputs as
    :func:`spu_encode_batch`: -> ((B, T, 16) uint8 blocks with the
    loop-flag byte 0 for the muxer to fill (adpcm.c:356-376), s1, s2
    (B, T))."""
    h, words, s1, s2 = _adpcm_words(units, limits, prev1, prev2,
                                    adpcm_ops.SPU_FILTER_COUNT,
                                    adpcm_ops.SHIFT_RANGE_4BPS)
    B, T = h.shape
    # Nibble m of word k sits at bit 4m: the words' little-endian bytes
    # are the block's sample bytes.
    shifts = 8 * torch.arange(4, dtype=torch.int32, device=words.device)
    payload = ((words[..., None] >> shifts) & 0xFF).reshape(B, T, 16)
    blocks = torch.cat([h[..., None] & 0xFF, torch.zeros_like(h)[..., None],
                        payload[..., :14]], dim=2)
    return blocks.to(torch.uint8), s1, s2


def xa_encode_batch(units, limits, prev1, prev2, *, bits8=False):
    """XA-ADPCM unit batch (4 filters; 4- or 8-bit): inputs and outputs
    as :func:`spu_encode_batch`."""
    return _adpcm_batch(units, limits, prev1, prev2,
                        adpcm_ops.XA_FILTER_COUNT,
                        adpcm_ops.SHIFT_RANGE_8BPS if bits8
                        else adpcm_ops.SHIFT_RANGE_4BPS)


class _Stages:
    """The kernel stages: the wrappers, or the plain versions (which run on
    any device, for measuring the plain path on the card)."""

    def __init__(self, use_kernels):
        if use_kernels:
            self.nv21_pix_dc = bs_cuda.nv21_pix_dc
            self.dc_stage = bs_cuda.dc_stage
            self.select = bs_cuda.select_scale_pix
            self.emit_prep = bs_cuda.emit_prep
            self.emit_pack = bs_cuda.emit_pack
            self.emit_tail = bs_cuda.emit_tail
            self.place = bitpack_cuda.place_vals
            self.place_gather = bitpack_cuda.place_vals_gather
            self.place_streams = bitpack_cuda.place_streams_u32
        else:
            self.nv21_pix_dc = bs_cuda.nv21_pix_dc_plain
            self.dc_stage = bs_cuda.dc_stage_plain
            self.select = bs_cuda.select_scale_pix_plain
            self.emit_prep = bs_cuda.emit_prep_plain
            self.emit_pack = bs_cuda.emit_pack_plain
            self.emit_tail = bs_cuda.emit_tail_plain
            self.place = bitpack_cuda.place_vals_plain
            self.place_gather = bitpack_cuda.place_vals_gather_plain
            self.place_streams = bitpack_cuda.place_streams_u32_plain


_KERNELS = _Stages(True)
_PLAIN = _Stages(False)

PACKERS = ("fused_mxu", "fused", "fused_pallas", "fused_gather", "blocks",
           "blocks_pallas", "flat")


def _eof(codec):
    return 0x1FF if codec == bs_ops.BS_V2 else 0x3FF


def _with_eof_symbols(codes, bits, eof):
    """Append the end-of-frame block (a lone 10-bit code) to (B, NB, S)
    symbol tensors."""
    B, _, S = codes.shape
    eof_codes = torch.zeros((B, 1, S), dtype=codes.dtype, device=codes.device)
    eof_bits = torch.zeros((B, 1, S), dtype=bits.dtype, device=bits.device)
    eof_codes[:, 0, 0] = eof
    eof_bits[:, 0, 0] = 10
    return torch.cat([codes, eof_codes], dim=1), \
        torch.cat([bits, eof_bits], dim=1)


def _overflow_words(coefs, scale_idx, dc_bits, dc_code, eof,
                    capacity_words):
    """Exact flat path for frames with a block stream over 256 bits
    (api.py:212-235 of psxavenc_tpu), kept as the reference that the
    tests and chip_smoke.py hold the tail emission to; no packer calls
    it. Emits the symbols at the selected scale and packs them with
    ``pack_bits``. ``coefs`` is either emission input form. Returns (n,
    capacity_words) int16 words."""
    n, nb = dc_code.shape
    c = coefs[:, :63, :nb].to(torch.int32)
    codes, bits = bs_ops.emit_symbols_at(c, scale_idx, dc_bits, dc_code)
    codes, bits = _with_eof_symbols(codes, bits, eof)
    words, _ = bitpack_ops.pack_bits(codes.reshape(n, -1),
                                     bits.reshape(n, -1),
                                     capacity_words=capacity_words)
    return bitpack_ops.u16_to_i16(words)


def _frames_to_coefs(frames, width, height):
    """(B, w*h*3/2) NV21 -> (B, NB, 64) int32 FDCT coefficients in encode
    order."""
    blocks = bs_ops.rearrange_nv21_frame(frames, width, height)
    return fdct_ops.fdct_islow(blocks).reshape(frames.shape[0], -1, 64)


def bs_encode_frames(frames, budgets, *, codec, width, height,
                     kernel_sweep=True):
    """BS frame batch: (B, w*h*3/2) uint8 NV21 frames and (B,) int32 byte
    budgets on one device -> per-frame symbol streams, the dict of
    ``ops.bs.encode_frames_symbols``: ``scale`` (B,), ``codes`` and
    ``bits`` (B, NB, 65) int64, ``nz_count`` (B,), ``total_bits`` (B,)
    (without the 10-bit EOF). ``kernel_sweep`` is the counterpart of
    psxavenc_tpu's ``pallas_sweep``: True selects scales with K6, False
    with the plain chunked sweep."""
    coefs = _frames_to_coefs(frames, width, height)
    return bs_ops.encode_frames_symbols(coefs, budgets, codec=codec,
                                        kernel_sweep=kernel_sweep)


def _select_stages(codec, width, height, st):
    """The fused select stage (psxavenc_tpu's ``select_frames_pixels``) as
    ordered (name, fn) stages: the pixel rows and quantized DCs, then
    ``ops.bs.select_stages`` (DC stage, AC threshold, FDCT + scale search
    (K1), totals) on ``st``'s kernels or plain versions. Each fn(s) reads
    what the stages before it put into the dict ``s`` (first ``frames``
    and ``budgets``) and adds its own results; ``nv21`` takes ``frames``
    out of ``s``, the NV21 kernel being their last reader."""

    def nv21(s):
        s["pix"], s["dc_q"] = st.nv21_pix_dc(s.pop("frames"), width, height)

    return [("nv21", nv21)] + bs_ops.select_stages(codec, st.dc_stage,
                                                   st.select)


def _emit_stages(packer, prep, eof, capacity_words, st):
    """The fused packers after selection as ordered (name, fn) stages, as
    ``_select_stages``'s: emission and placement into (B, cap32) u32 words
    (with ``prep``, K3's placement prep then K4, or K8 for
    ``fused_gather``; else K7's per-block streams placed by the plain
    stream placement, K9, or ``streams_to_u32`` and K4 or K8), then the
    tail emission, which ORs the part of every block past the 256-bit
    window into them and counts the frames that have such a block, then
    ``words``: (B, capacity_words) int16."""
    place_vals = st.place_gather if packer == "fused_gather" else st.place

    def args(s):
        # The emission's inputs, made once for it and the tail emission.
        s["emit_args"] = (s["c"], s["scale_idx"] + 1, s["dc_code"],
                          s["dc_bits"])
        return s["emit_args"]

    def k3(s):
        s["vals32"], s["e0"], s["block_bits"], _ = st.emit_prep(*args(s),
                                                                eof=eof)

    def k4(s):
        s["out32"] = place_vals(s["vals32"], s["e0"],
                                capacity_words=capacity_words)

    def k7(s):
        streams, s["block_bits"] = st.emit_pack(*args(s))
        s["streams"], bb = bitpack_ops.with_eof_block(streams,
                                                      s["block_bits"], eof)
        s["goff"] = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb

    def place(s):
        if packer == "fused":
            fn = bitpack_cuda.place_streams_u32_plain    # the XLA stage
        elif packer == "fused_pallas":
            fn = st.place_streams
        else:
            fn = functools.partial(bitpack_cuda.place_streams_mxu_u32,
                                   place=place_vals)
        s["out32"] = fn(s["streams"], s["goff"],
                        capacity_words=capacity_words)

    def tail(s):
        s["out32"], _ = st.emit_tail(
            s["out32"], *s["emit_args"], s["block_bits"],
            capacity_words=capacity_words,
            count=COUNTERS.device_count(s["out32"].device))

    def words(s):
        s["words"] = bitpack_ops.words_u16(s["out32"], capacity_words)

    head = [("k3", k3), ("k4", k4)] if prep else [("k7", k7),
                                                  ("place", place)]
    return head + [("tail", tail), ("words", words)]


def step_stages(*, codec, width, height, capacity_words, use_kernels=True):
    """The default step of ``bs_encode_frames_packed`` (``fused_mxu`` with
    the kernel sweep) as its ordered (name, fn) stages: ``nv21`` (the
    pixel rows and quantized DCs), ``dc`` (K2, or v2's DC codes),
    ``threshold``, ``k1``, ``totals``, ``k3``,
    ``k4``, ``tail``, ``words``. Each fn(state) reads what the stages
    before it put into the dict ``state`` (first ``frames`` and
    ``budgets``) and adds its own, and takes out what it reads last
    (``nv21`` the frames, ``dc`` the DCs, ``k1`` the pixel rows); after
    the last, ``state`` holds the step's ``words``, ``scale``,
    ``total_bits`` and ``nz_count``. The step runs these very stages;
    tools/torch_profile_stages.py times each alone."""
    st = _KERNELS if use_kernels else _PLAIN
    return (_select_stages(codec, width, height, st)
            + _emit_stages("fused_mxu", True, _eof(codec), capacity_words,
                           st))


def run_stages(stages, state):
    """Run ``stages`` in order on the dict ``state``; returns it."""
    for _, fn in stages:
        fn(state)
    return state


def _select_batch(batch, codec, width, height, st, k1_stats):
    """``_select_stages`` run on the dict ``batch`` of ``frames`` and
    ``budgets``, which becomes the state dict, with ``scale``,
    ``scale_idx``, ``nz_count``, ``total_bits``, ``dc_bits``, ``dc_code``
    and the zigzag coefficients ``c`` (the frames and pixel rows taken out
    of it); with ``k1_stats``, also K1's statistics rows ``k1_stats``."""
    if k1_stats:
        budgets = batch["budgets"]
        batch["k1_stats"] = torch.empty(
            (budgets.shape[0], len(bs_cuda.STAT_NAMES)), dtype=torch.int32,
            device=budgets.device)
    return run_stages(_select_stages(codec, width, height, st), batch)


def _select_pixels(frames, budgets, codec, width, height, st,
                   k1_stats=False):
    """``_select_batch`` on frames the caller keeps."""
    return _select_batch({"frames": frames, "budgets": budgets}, codec,
                         width, height, st, k1_stats)


def _fused_words(sel, packer, prep, eof, capacity_words, st):
    """``_emit_stages`` run on a copy of the selection ``sel``: (B,
    capacity_words) int16 words."""
    return run_stages(_emit_stages(packer, prep, eof, capacity_words, st),
                      dict(sel))["words"]


def _fused_out(sel, packer, prep, eof, capacity_words, st):
    """The fused packers' result dict from the selection ``sel``."""
    out = {"scale": sel["scale"],
           "words": _fused_words(sel, packer, prep, eof, capacity_words, st),
           "total_bits": sel["total_bits"], "nz_count": sel["nz_count"]}
    if "k1_stats" in sel:
        out["k1_stats"] = sel["k1_stats"]
        out["dc_total"] = sel["dc_total"]
    return out


def bs_encode_frames_owned(batch, *, codec, width, height, capacity_words,
                           k1_stats=False):
    """:func:`bs_encode_frames_packed`'s default step (``fused_mxu`` with
    the kernel sweep, on the kernels) on frames that its caller gives up.
    ``batch`` is a dict of the (B, w*h*3/2) uint8 ``frames`` and (B,)
    int32 ``budgets`` on one device, and no other reference to the frames
    tensor remains: a tensor passed as an argument stays alive for the
    whole call, one in a dict the step empties does not. The step runs on
    ``batch`` as its state, so the frames are freed right after the NV21
    kernel, their last reader, and the pixel rows after K1, on the current
    stream, before K1's coefficients are made; ``batch`` is empty on
    return. Returns the dict of :func:`bs_encode_frames_packed`."""
    sel = _select_batch(batch, codec, width, height, _KERNELS, k1_stats)
    out = _fused_out(sel, "fused_mxu", True, _eof(codec), capacity_words,
                     _KERNELS)
    batch.clear()
    return out


def bs_encode_frames_packed(frames, budgets, *, codec, width, height,
                            capacity_words, kernel_sweep=True, packer=None,
                            use_kernels=True, k1_stats=False):
    """BS frame batch, pixels in, packed bitstream out: (B, w*h*3/2) uint8
    NV21 frames and (B,) int32 byte budgets on one device -> dict of
    device tensors:

    - ``scale`` (B,) int32: chosen quant scales, 64 = unfittable (the
      caller raises, mdec.c:723);
    - ``words`` (B, capacity_words) int16: the packed payload, the bit
      patterns of little-endian u16 words (view as uint16 on the host);
    - ``total_bits`` (B,) int32: bitstream bits including the EOF code;
    - ``nz_count`` (B,) int32: nonzero AC count at the chosen scale.

    ``capacity_words`` must cover the largest budget: (max - 8) // 2.
    ``kernel_sweep`` (psxavenc_tpu's ``pallas_sweep``) selects scales with
    K1 from the pixels (True) or with the plain chunked sweep from FDCT
    coefficients (False). ``packer`` takes psxavenc_tpu's names (all give
    the same bytes); default ``fused_mxu`` with the kernel sweep,
    ``blocks`` without it:

    - ``fused_mxu``: K3 emission + placement prep, then K4 placement, then
      the tail emission; with ``kernel_sweep=False``, K7 emission, then
      ``streams_to_u32`` + K4, then the tail emission;
    - ``fused_gather``: as ``fused_mxu`` with K8 in place of K4;
    - ``fused``: K7 emission, then the plain stream placement
      (psxavenc_tpu's XLA ``_place_streams``), then the tail emission;
    - ``fused_pallas``: K7 emission, then K9 placement, then the tail
      emission;
    - ``blocks``: K6 (or the sweep), plain symbol emission, then the
      plain per-block packer (``_pack_block_streams`` + ``_place_streams``);
    - ``blocks_pallas``: as ``blocks`` with K10 packing and K9 placement;
    - ``flat``: K6 (or the sweep), plain symbol emission, ``pack_bits``.

    The ``fused*`` packers with the kernel sweep run the NV21 kernel
    (``ops.bs_cuda.nv21_pix_dc``) and K1 (and K2 for v3/v3dc) first. A
    block over 256 bits: every ``fused*`` packer places each block's first
    256 bits (K3's placement prep, or K7's streams) and
    ORs the rest into the placed words with the tail emission
    (``ops.bs_cuda.emit_tail``, the same file as K3 and K7; its plain
    version on the CPU and with ``use_kernels=False``), on the card with
    no plain packing and no wait for the device (psxavenc_tpu sends the
    batch through the flat packer instead; the bytes are the same). The
    tail emission counts the frames that have such a block on their
    device (``COUNTERS["overflow_frames"]``). ``total_bits`` is the
    selection's for the fused packers and the packer's for the others;
    they differ only on an unfittable frame. ``use_kernels=False`` runs
    the plain versions on any device (for measuring the plain path; never
    chosen automatically). ``k1_stats=True`` (the ``fused*`` packers with
    the kernel sweep only, which run K1; ValueError otherwise) adds
    ``k1_stats`` to the dict: (B, 8) int32, K1's statistics of each frame
    (``ops.bs_cuda.STAT_NAMES``; zero where its plain version ran); the
    step makes that tensor only then. It also adds ``dc_total``, (B,)
    int32, each frame's DC bits, which the step holds anyway. The step
    only reads ``frames``, and holds its pixel rows only up to K1; the
    frames stay the caller's
    (:func:`bs_encode_frames_owned` frees them after the NV21 kernel).
    """
    if packer is None:
        packer = "fused_mxu" if kernel_sweep else "blocks"
    if packer not in PACKERS:
        raise ValueError(f"unknown packer {packer!r}; one of {PACKERS}")
    st = _KERNELS if use_kernels else _PLAIN
    eof = _eof(codec)

    if k1_stats and not (packer.startswith("fused") and kernel_sweep):
        raise ValueError(f"k1_stats: packer {packer!r} with kernel_sweep="
                         f"{kernel_sweep} does not run K1")

    if packer.startswith("fused"):
        if kernel_sweep:
            sel = _select_pixels(frames, budgets, codec, width, height, st,
                                 k1_stats)
        else:
            sel = bs_ops.encode_frames_symbols(
                _frames_to_coefs(frames, width, height), budgets,
                codec=codec, kernel_sweep=False, emit=False)
        return _fused_out(
            sel, packer, kernel_sweep and packer in ("fused_mxu",
                                                     "fused_gather"),
            eof, capacity_words, st)

    out = bs_ops.encode_frames_symbols(
        _frames_to_coefs(frames, width, height), budgets, codec=codec,
        kernel_sweep=kernel_sweep, use_kernels=use_kernels)
    codes, bits = _with_eof_symbols(out["codes"], out["bits"], eof)
    if packer == "flat":
        B = codes.shape[0]
        words, total_bits = bitpack_ops.pack_bits(
            codes.reshape(B, -1), bits.reshape(B, -1),
            capacity_words=capacity_words)
    else:
        kern = use_kernels and packer == "blocks_pallas"
        words, total_bits = bitpack_ops.pack_frames_blocks(
            codes, bits, capacity_words=capacity_words, kernel_place=kern,
            kernel_pack=kern)
    return {"scale": out["scale"], "words": bitpack_ops.u16_to_i16(words),
            "total_bits": total_bits.to(torch.int32),
            "nz_count": out["nz_count"]}
