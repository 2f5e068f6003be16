"""The generator: the same seed gives the same inputs, another seed other
content over the same sizes; the pacing gives the schedule's budgets."""

import json
import os

import numpy as np
import pytest
from conftest import BENCH

from benchlib import pacing, traffic

SEEDS = (7, 2**31 + 12345, 4_000_000_011)


@pytest.mark.parametrize("seed", SEEDS)
def test_movie_is_a_function_of_the_seed(seed):
    a = traffic.movie(seed, 12, 48, 32, "cpu", scene_frames=5)
    b = traffic.movie(seed, 12, 48, 32, "cpu", scene_frames=5)
    c = traffic.movie(seed + 1, 12, 48, 32, "cpu", scene_frames=5)
    assert a.shape == (12, 48 * 32 * 3 // 2) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("mix", ["bank", "long"])
def test_clips_keep_their_sizes_across_seeds(mix):
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        spec = json.load(f)
    spec = dict(spec, min_seconds=spec["min_seconds"] / 1000,
                max_seconds=spec["max_seconds"] / 1000)
    lengths = traffic.clip_lengths(spec, 44100)
    assert len(lengths) == spec["clips"]
    a, oa = traffic.clips(SEEDS[0], lengths, 44100, "cpu")
    b, ob = traffic.clips(SEEDS[0], lengths, 44100, "cpu")
    c, oc = traffic.clips(SEEDS[1], lengths, 44100, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(map(len, a)) == sorted(map(len, c)) == sorted(lengths)
    assert [len(x) for x in a] == [lengths[k] for k in oa]
    assert any(not np.array_equal(x, y) for x, y in zip(a, c)
               if len(x) == len(y)) or list(oa) != list(oc)
    assert all(x.dtype == np.int16 for x in a)


def test_str_budgets_follow_the_interleave():
    with open(os.path.join(BENCH, "configs", "str-v2-320x240.json")) as f:
        cfg = json.load(f)
    b = pacing.frame_budgets(cfg, 900)
    assert set(b) == {8 * 2016, 9 * 2016}
    assert sum(b) / 2016 / 900 == pytest.approx(8.75)
    assert b[:4] == [8 * 2016, 9 * 2016, 9 * 2016, 9 * 2016]
