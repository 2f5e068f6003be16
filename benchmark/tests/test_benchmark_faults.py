"""`correct` comes out false for each fault the cells can have, planted
under a whole CPU run of a tiny cell (the look for a card skipped; the
CLI's cell on PSXAVENC_PLATFORM=cpu), and for the controls; the sound
runs read true. The controls at the cells' own sizes run on the card
(``benchmark/control.py``)."""

import pytest
import torch
from conftest import run_cell

from benchref import adpcm as ref_adpcm
from benchref import bs as ref_bs


def test_sound_runs_are_correct(monkeypatch, tiny_tree):
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    for name in ("str.tiny", "vag.tiny", "movie.tiny"):
        r = run_cell(tiny_tree, name)
        assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
        assert list(r)[-1] == "checks"


def _video_tier(monkeypatch):
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", "device")
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    from psxavenc_tpu_torch import api
    return api


@pytest.mark.parametrize("cell", ["str.tiny", "movie.tiny"])
def test_video_answer_altered(monkeypatch, tiny_tree, cell):
    api = _video_tier(monkeypatch)
    real = api.bs_encode_frames_packed

    def altered(frames, budgets, **kw):
        out = real(frames, budgets, **kw)
        out["words"][0, 3] ^= 0x10
        return out

    monkeypatch.setattr(api, "bs_encode_frames_packed", altered)
    assert not run_cell(tiny_tree, cell)["correct"]


def test_video_half_batch_left_out(monkeypatch, tiny_tree):
    api = _video_tier(monkeypatch)
    real = api.bs_encode_frames_packed

    def half(frames, budgets, **kw):
        k = frames.shape[0] // 2
        out = real(frames[:k], budgets[:k], **kw)
        return {n: torch.cat([v, v[-1:].expand(frames.shape[0] - k,
                                               *v.shape[1:])])
                for n, v in out.items()}

    monkeypatch.setattr(api, "bs_encode_frames_packed", half)
    assert not run_cell(tiny_tree, "str.tiny")["correct"]


def _units(monkeypatch, fault):
    from psxavenc_tpu_torch.models import adpcm_stream
    real = adpcm_stream.encode_prepared_units

    def wrapped(units, lim, *a, **kw):
        h, v, s1, s2 = real(units, lim, *a, **kw)
        return fault(h, v), v, s1, s2

    monkeypatch.setattr(adpcm_stream, "encode_prepared_units", wrapped)


def test_audio_answer_altered(monkeypatch, tiny_tree):
    def flip(h, v):
        h = h.copy()
        h[0, 0] ^= 0x01
        return h
    _units(monkeypatch, flip)
    assert not run_cell(tiny_tree, "vag.tiny")["correct"]


def test_audio_half_batch_left_out(monkeypatch, tiny_tree):
    def half(h, v):
        h = h.copy()
        h[h.shape[0] // 2:] = 0
        v[v.shape[0] // 2:] = 0
        return h
    _units(monkeypatch, half)
    assert not run_cell(tiny_tree, "vag.tiny")["correct"]


def test_video_control_fails():
    """The float32 DCT in place of the integer one: frames differ."""
    from benchlib import traffic
    frames = torch.from_numpy(traffic.movie(21, 8, 64, 48, "cpu",
                                            scene_frames=4))
    budgets = torch.full((8,), 2016)
    ref, _, _ = ref_bs.encode_frames(frames, budgets, 64, 48)
    ctl, _, _ = ref_bs.encode_frames(frames, budgets, 64, 48,
                                     dct=ref_bs.fdct_float)
    assert sum(not torch.equal(a, b) for a, b in zip(ref, ctl)) > 0


def test_movie_sound_altered(monkeypatch, tiny_tree):
    """An XA unit's header altered where the unit encoder produces it."""
    from psxavenc_tpu_torch.models import adpcm_stream
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    real = adpcm_stream.encode_unit_streams

    def altered(*a, **kw):
        h, v, s1, s2 = real(*a, **kw)
        h = h.copy()
        h[0, -1] ^= 0x01
        return h, v, s1, s2

    monkeypatch.setattr(adpcm_stream, "encode_unit_streams", altered)
    assert not run_cell(tiny_tree, "movie.tiny")["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_audio_control_fails(seed):
    """Segments from guessed states, not repaired: files differ."""
    from benchlib import traffic
    clips, _ = traffic.clips(seed, [20000, 30000, 40000], 44100, "cpu")
    clips = [torch.from_numpy(c) for c in clips]
    names = ["a.vag", "b.vag", "c.vag"]
    ref = ref_adpcm.vag_files(clips, names, 44100)
    ctl = ref_adpcm.vag_files(clips, names, 44100, rounds=1)
    assert sum(a != b for a, b in zip(ref, ctl)) > 0


def test_movie_control_fails():
    """The .str file of the float32 DCT differs from the reference's."""
    import numpy as np

    from benchlib import traffic
    from benchref import strmux
    cfg = dict(width=64, height=48, fps_num=15, fps_den=1, cd_speed=2,
               audio_frequency=37800, audio_channels=2, audio_bit_depth=4)
    frames = traffic.movie(4, 12, 64, 48, "cpu", scene_frames=6)
    tracks, _ = traffic.clips(4, [30240, 30240], 37800, "cpu")
    pcm = np.stack(tracks, 1)
    assert strmux.str_file(cfg, frames, pcm, "cpu") != strmux.str_file(
        cfg, frames, pcm, "cpu", dct=ref_bs.fdct_float)
