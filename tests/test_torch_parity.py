"""Helpers of the psxavenc_tpu_torch parity tests (no tests of their own).

The same seeded numpy inputs go through a psxavenc_tpu (JAX) function and
its psxavenc_tpu_torch counterpart; integer codecs compare with exact
equality. JAX runs on the CPU and its Pallas kernels in interpret mode,
as the JAX package's own tests run them.
"""

import numpy as np
import torch

import jax.numpy as jnp

# The test workers run side by side: one intra-op thread each keeps torch
# from oversubscribing the cores.
torch.set_num_threads(1)


def to_np(x):
    """jax array / torch tensor / numpy -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(want, got, name="", u32=False):
    """Exact equality of integer arrays whatever their dtypes; with
    ``u32`` both sides compare as 32-bit patterns (uint32 vs int32)."""
    w = to_np(want).astype(np.int64)
    g = to_np(got).astype(np.int64)
    if u32:
        w &= 0xFFFFFFFF
        g &= 0xFFFFFFFF
    assert w.shape == g.shape, (name, w.shape, g.shape)
    assert np.array_equal(w, g), (name, int(np.sum(w != g)))


def run_both(jax_fn, torch_fn, *inputs, u32=False):
    """Feed numpy ``inputs`` to both functions and assert equal outputs
    (tuples compare element-wise)."""
    want = jax_fn(*[jnp.asarray(a) for a in inputs])
    got = torch_fn(*[torch.from_numpy(np.array(a)) for a in inputs])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_same(w, g, name=f"output {i}", u32=u32)
    return want, got


def nv21(planes, w, h):
    """(y, cb, cr) I420 planes -> NV21 bytes (Y, then Cr/Cb pairs)."""
    y, cb, cr = planes
    c = np.stack([np.asarray(cr).reshape(h // 2, w // 2),
                  np.asarray(cb).reshape(h // 2, w // 2)], axis=-1)
    return np.concatenate([np.asarray(y).reshape(-1),
                           c.reshape(-1)]).astype(np.uint8)


def video_frames(w, h, n, seed, noise=1):
    """(n + noise, w*h*3/2) uint8 NV21: synthetic video, then noise."""
    from psxavenc_tpu.utils.synth import rand_frames

    rng = np.random.default_rng(seed)
    out = [nv21(f, w, h) for f in rand_frames(w, h, n, seed=seed)]
    out += [rng.integers(0, 256, w * h * 3 // 2).astype(np.uint8)
            for _ in range(noise)]
    return np.stack(out)
