"""The slice at full width: BsFrameEncoder on 320x240 frames equals the
native C++ tier's words and psxavenc_tpu's encoder's frame buffers."""

import numpy as np
import pytest

from psxavenc_tpu import native
from psxavenc_tpu.models.bs_video import BsFrameEncoder as JaxEncoder
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu_torch.models import bs_video

from test_torch_parity import video_frames

W, H = 320, 240


@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3DC])
def test_encoder_matches_native_320x240(codec):
    # The noise frame (its busy blocks take the overflow path) goes first:
    # the encoder pads the batch with copies of the last frame.
    frames = np.roll(video_frames(W, H, 4, seed=3), 1, axis=0)
    budgets = [18144, 8064, 18144, 12096, 18144]
    cap = (18144 - 8 + 1) // 2
    nat = native.bs_encode_frames(frames, np.array(budgets, np.int32),
                                  codec=codec, width=W, height=H,
                                  capacity_words=cap)
    enc = bs_video.BsFrameEncoder(codec, W, H, "cpu")
    got = enc.encode_frames(list(frames), budgets)
    ref = JaxEncoder(codec, W, H)
    try:
        want = ref.encode_frames(list(frames), budgets)
    finally:
        ref.close()
    for j, ((buf, info), (wbuf, winfo)) in enumerate(zip(got, want)):
        assert info == winfo, j
        assert info["quant_scale"] == nat["scale"][j]
        assert buf.tobytes() == wbuf.tobytes(), j
        payload = nat["words"][j].astype("<u2").tobytes()
        assert buf[8:].tobytes() == payload[:budgets[j] - 8], j
    assert enc.quant_scale_sum == ref.quant_scale_sum


def test_async_fetch_and_unfittable():
    """encode_frames_async/fetch == encode_frames; a frame that fits at
    no scale raises like the reference (mdec.c:723)."""
    w, h = 48, 32
    frames = list(video_frames(w, h, 3, seed=4, noise=1))
    budgets = [2000, 1000, 2000, 2000]
    enc = bs_video.BsFrameEncoder(jbs.BS_V3, w, h, "cpu")
    a = enc.encode_frames(frames, budgets)
    b = enc.fetch(enc.encode_frames_async(frames, budgets))
    assert [x[0].tobytes() for x in a] == [x[0].tobytes() for x in b]
    with pytest.raises(RuntimeError, match="does not fit"):
        enc.encode_frames(frames, [2000, 1000, 2000, 100])


def test_stack_frames_zero_copy_and_padding():
    rows = np.arange(5 * 12, dtype=np.uint8).reshape(5, 12)
    view = bs_video._stack_frames(list(rows), 5)
    assert np.shares_memory(view, rows) and np.array_equal(view, rows)
    padded = bs_video._stack_frames(list(rows[:3]), 8)
    assert padded.shape == (8, 12)
    assert np.array_equal(padded[3:], np.repeat(rows[2:3], 5, axis=0))
