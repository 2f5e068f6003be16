"""The port's libpsxav API equals psxavenc_tpu's, function for function,
on the CPU (the plain ADPCM search): the sizing helpers, the CD-ROM
helpers, SPU and XA encodes with the caller's state threaded through, and
the EOF finalize. Mirrors tests/test_libpsxav.py."""

import dataclasses

import numpy as np
import pytest

from psxavenc_tpu import libpsxav as jlp
from psxavenc_tpu.utils.synth import rand_pcm
from psxavenc_tpu_torch import libpsxav as tlp

from test_torch_parity import plain_tiers

CPU = "cpu"


SETTINGS = [dict(stereo=True, bits_per_sample=4, frequency=37800),
            dict(stereo=False, bits_per_sample=8, frequency=18900,
                 format=1, file_number=3, channel_number=5)]


def test_constants_match():
    names = [n for n in dir(jlp) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tlp, n) == getattr(jlp, n), n


@pytest.mark.parametrize("kw", SETTINGS)
def test_sizing_helpers_match(kw):
    js, ts = jlp.XaSettings(**kw), tlp.XaSettings(**kw)
    for fn in ("xa_get_samples_per_sector", "xa_get_buffer_size_per_sector",
               "xa_get_sector_interleave"):
        assert getattr(tlp, fn)(ts) == getattr(jlp, fn)(js), fn
    for n in (0, 1, 4031, 4032, 4033, 100000):
        assert tlp.xa_get_buffer_size(ts, n) == jlp.xa_get_buffer_size(js, n)
        assert tlp.spu_get_buffer_size(n) == jlp.spu_get_buffer_size(n)


@pytest.mark.parametrize("stype", [0, 1, 2])
def test_cdrom_helpers_match(stype):
    got = np.zeros(2352, np.uint8)
    want = np.zeros(2352, np.uint8)
    got[24:2072] = want[24:2072] = np.arange(2048) % 251
    tlp.cdrom_init_sector(got, 1234, stype)
    jlp.cdrom_init_sector(want, 1234, stype)
    np.testing.assert_array_equal(got, want)
    tlp.cdrom_calculate_checksums(got, stype)
    jlp.cdrom_calculate_checksums(want, stype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlp.cdrom_init_xa_subheader(stype),
                                  jlp.cdrom_init_xa_subheader(stype))


@pytest.mark.parametrize("pitch", [1, 2])
def test_spu_encode_threads_state(pitch):
    """Two calls in a row from a nonzero state: the bytes and the state
    after each equal the JAX package's."""
    pcm = rand_pcm(28 * 9 + 5, channels=pitch, seed=11).reshape(-1)
    ts = tlp.ChannelState(prev1=1200, prev2=-800)
    js = jlp.ChannelState(prev1=1200, prev2=-800)
    for part in (pcm[:28 * 4 * pitch], pcm[28 * 4 * pitch:]):
        with plain_tiers():
            got = tlp.spu_encode(ts, part, pitch=pitch, device=CPU)
        want = jlp.spu_encode(js, part, pitch=pitch)
        assert got == want and len(got) > 0
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    with plain_tiers():
        assert tlp.spu_encode(ts, pcm, sample_count=0, device=CPU) == b""


@pytest.mark.parametrize("loop_start", [-1, 0, 57])
def test_spu_encode_simple_matches(loop_start):
    pcm = rand_pcm(28 * 5 + 3, seed=3)
    with plain_tiers():
        got = tlp.spu_encode_simple(pcm, loop_start, device=CPU)
    assert got == jlp.spu_encode_simple(pcm, loop_start)


@pytest.mark.parametrize("kw", SETTINGS)
def test_xa_encode_threads_state(kw):
    """xa_encode twice from a nonzero state at a nonzero LBA (a partial
    last sector), then finalize: bytes and state equal the JAX
    package's."""
    js, ts = jlp.XaSettings(**kw), tlp.XaSettings(**kw)
    ch = 2 if kw["stereo"] else 1
    sps = jlp.xa_get_samples_per_sector(js)
    n = sps + 300
    pcm = rand_pcm(2 * n, channels=ch, seed=5).reshape(-1)
    jstate, tstate = jlp.EncoderState(), tlp.EncoderState()
    for st in (jstate, tstate):
        st.left.prev1, st.left.prev2 = 321, -77
        st.right.prev1, st.right.prev2 = -5, 900
    out_j, out_t = b"", b""
    for k in range(2):
        part = pcm[k * n * ch:(k + 1) * n * ch]
        out_j += jlp.xa_encode(js, jstate, part, n, 150 + 2 * k)
        with plain_tiers():
            out_t += tlp.xa_encode(ts, tstate, part, n, 150 + 2 * k,
                                   device=CPU)
        assert dataclasses.astuple(tstate) == dataclasses.astuple(jstate)
    assert out_t == out_j
    assert len(out_t) == 4 * jlp.xa_get_buffer_size_per_sector(js)
    assert tlp.xa_encode_finalize(ts, out_t) == \
        jlp.xa_encode_finalize(js, out_j)
    with plain_tiers():
        assert tlp.xa_encode(ts, tstate, pcm, 0, 0, device=CPU) == b""


def test_xa_encode_simple_matches():
    kw = SETTINGS[0]
    n = 112 * 18 + 40
    pcm = rand_pcm(n, channels=2, seed=7).reshape(-1)
    with plain_tiers():
        got = tlp.xa_encode_simple(tlp.XaSettings(**kw), pcm, n, lba=9,
                                   device=CPU)
    assert got == jlp.xa_encode_simple(jlp.XaSettings(**kw), pcm, n, lba=9)
