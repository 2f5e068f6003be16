"""BsFrameEncoder's pipeline on the CPU: ``encode_frames`` enqueues the
next batch before it assembles this one, in the calling thread; the
bytes, the frame infos, ``quant_scale_sum`` and
``COUNTERS["overflow_frames"]`` equal one batch at a time and
psxavenc_tpu's encoder exactly, also with two batches enqueued before
either is fetched. An unfittable frame still raises, and a batch whose
launch fails is not dropped. The counter stays exact with adds from
other threads.

Frames are 64x48 (eight-frame batches) and 320x240, with noise frames
whose busy blocks run past 256 bits at the generous budgets."""

import sys
import threading

import numpy as np
import pytest
import torch

from psxavenc_tpu.models.bs_video import BsFrameEncoder as JaxEncoder
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.models import bs_video

from test_torch_parity import plain_tiers, video_frames

W, H = 64, 48


def _frames(w, h, n, seed, noise):
    """n distinct NV21 frames, ``noise`` of them noise, in a seeded order,
    and per-frame budgets (generous, tight and in between)."""
    rng = np.random.default_rng(seed)
    frames = video_frames(w, h, n - noise, seed, noise=noise)
    frames = frames[rng.permutation(n)]
    full = w * h * 3 // 2
    budgets = [int(b) for b in rng.choice([full, full // 2, full // 4], n)]
    return list(frames), budgets


def _one_at_a_time(enc, frames, budgets, batch=8):
    out = []
    for base in range(0, len(frames), batch):
        out += enc.fetch(enc.encode_frames_async(frames[base:base + batch],
                                                 budgets[base:base + batch]))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for j, ((buf, info), (wbuf, winfo)) in enumerate(zip(got, want)):
        assert info == winfo, j
        assert buf.tobytes() == wbuf.tobytes(), j


@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3, jbs.BS_V3DC])
def test_pipelined_equals_one_batch_at_a_time_and_jax(codec):
    """30 distinct frames, four batches of eight (the last one partial)."""
    frames, budgets = _frames(W, H, 30, seed=3, noise=5)
    with plain_tiers():
        pipe = bs_video.BsFrameEncoder(codec, W, H, "cpu")
        one = bs_video.BsFrameEncoder(codec, W, H, "cpu")
    ref = JaxEncoder(codec, W, H)
    try:
        tapi.COUNTERS["overflow_frames"] = 0
        with plain_tiers():
            got = pipe.encode_frames(frames, budgets)
            got_overflow = tapi.COUNTERS["overflow_frames"]
            want = _one_at_a_time(one, frames, budgets)
            want_overflow = tapi.COUNTERS["overflow_frames"] - got_overflow
        jax_out = ref.encode_frames(frames, budgets)
    finally:
        ref.close()
    _same(got, want)
    _same(got, jax_out)
    assert pipe.quant_scale_sum == one.quant_scale_sum == ref.quant_scale_sum
    assert got_overflow == want_overflow > 0


def test_pipelined_320x240():
    """20 frames at the main path's size: three batches of eight."""
    frames, budgets = _frames(320, 240, 20, seed=4, noise=3)
    with plain_tiers():
        pipe = bs_video.BsFrameEncoder(jbs.BS_V2, 320, 240, "cpu")
        one = bs_video.BsFrameEncoder(jbs.BS_V2, 320, 240, "cpu")
        tapi.COUNTERS["overflow_frames"] = 0
        got = pipe.encode_frames(frames, budgets)
        got_overflow = tapi.COUNTERS["overflow_frames"]
        want = _one_at_a_time(one, frames, budgets)
    want_overflow = tapi.COUNTERS["overflow_frames"] - got_overflow
    _same(got, want)
    assert pipe.quant_scale_sum == one.quant_scale_sum
    assert got_overflow == want_overflow > 0


def test_next_batch_enqueued_before_this_one_is_assembled(monkeypatch):
    """Three batches: each later batch is enqueued before the one before
    it is assembled, all in the calling thread (no thread is started)."""
    frames, budgets = _frames(W, H, 24, seed=5, noise=2)
    with plain_tiers():
        enc = bs_video.BsFrameEncoder(jbs.BS_V2, W, H, "cpu")
    order = []
    launch, collect = enc._launch, enc._collect

    def spy_launch(*a, **kw):
        order.append(("enqueue", threading.get_ident()))
        return launch(*a, **kw)

    def spy_collect(*a, **kw):
        order.append(("assemble", threading.get_ident()))
        return collect(*a, **kw)

    monkeypatch.setattr(enc, "_launch", spy_launch)
    monkeypatch.setattr(enc, "_collect", spy_collect)
    threads = threading.active_count()
    with plain_tiers():
        enc.encode_frames(frames, budgets)
    assert [k for k, _ in order] == ["enqueue", "enqueue", "assemble",
                                     "enqueue", "assemble", "assemble"]
    assert {t for _, t in order} == {threading.get_ident()}
    assert threading.active_count() == threads


def test_two_handles_before_either_is_fetched():
    frames, budgets = _frames(W, H, 16, seed=6, noise=2)
    with plain_tiers():
        enc = bs_video.BsFrameEncoder(jbs.BS_V3DC, W, H, "cpu")
        ref = bs_video.BsFrameEncoder(jbs.BS_V3DC, W, H, "cpu")
        first = enc.encode_frames_async(frames[:8], budgets[:8])
        second = enc.encode_frames_async(frames[8:], budgets[8:])
        got = enc.fetch(first) + enc.fetch(second)
        want = ref.encode_frames(frames, budgets)
    _same(got, want)
    assert enc.quant_scale_sum == ref.quant_scale_sum


def test_unfittable_frame_in_the_second_batch(monkeypatch):
    """The second of three batches holds a frame that fits at no scale: it
    raises as the reference does (mdec.c:723), after the first batch was
    assembled and the third enqueued; a batch whose launch fails raises
    its own error before the batch before it is assembled."""
    frames, budgets = _frames(W, H, 24, seed=7, noise=2)
    budgets[10] = 100
    with plain_tiers():
        enc = bs_video.BsFrameEncoder(jbs.BS_V2, W, H, "cpu")
        first_batch = bs_video.BsFrameEncoder(jbs.BS_V2, W, H, "cpu")
    calls = []
    step = tapi.bs_encode_frames_packed

    def counted(*args, **kw):
        calls.append(1)
        return step(*args, **kw)

    monkeypatch.setattr(tapi, "bs_encode_frames_packed", counted)
    with pytest.raises(RuntimeError, match="does not fit"):
        enc.encode_frames(frames, budgets)
    assert len(calls) == 3
    first = sum(i["quant_scale"]
                for _, i in first_batch.encode_frames(frames[:8],
                                                      budgets[:8]))
    # the first batch and the second's frames before frame 10
    assert first < enc.quant_scale_sum

    def third_fails(*args, **kw):
        calls.append(1)
        if len(calls) == 6:
            raise ValueError("the third batch's step failed")
        return step(*args, **kw)

    monkeypatch.setattr(tapi, "bs_encode_frames_packed", third_fails)
    with pytest.raises(ValueError, match="third batch's step failed"):
        enc.encode_frames(frames, budgets)


def test_overflow_counter_exact_across_threads():
    """Each thread adds to its own CPU count while another thread reads
    the counter: no add is lost and none is counted twice."""
    counters = tapi._Counters()
    n_threads, adds = 8, 300
    start = threading.Barrier(n_threads + 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            count = counters.device_count(torch.device("cpu"))
            start.wait(timeout=60)
            for _ in range(adds):
                count += 1

        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        start.wait(timeout=60)
        reads = [counters["overflow_frames"] for _ in range(200)]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert reads == sorted(reads)
    assert counters["overflow_frames"] == n_threads * adds
