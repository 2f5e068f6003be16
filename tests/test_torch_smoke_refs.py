"""The digests chip_smoke.py holds the card to are the JAX package's.

chip_smoke.py runs on a host without JAX; it compares the port's outputs
on the card with ``psxavenc_tpu_torch/data/smoke_digests.json``. This file
rebuilds each input from chip_smoke.py's recipes, encodes it with the JAX
package on the CPU (``psxavenc_tpu.cli.main``, and for the 256-frame
buffers ``psxavenc_tpu``'s BsFrameEncoder, whose CPU tier is the native
encoder that tier-1 holds equal to the JAX pipeline; for the symbols
digest ``psxavenc_tpu.api.bs_encode_frames`` with the XLA sweep; for the
libpsxav digests ``psxavenc_tpu.libpsxav``) and
asserts the committed digests, so they cannot go stale. It also holds the port's
``utils.synth`` to the JAX package's for those recipes.

Regenerate the digests file after a change to a recipe:

    JAX_PLATFORMS=cpu python tests/test_torch_smoke_refs.py \\
        > psxavenc_tpu_torch/data/smoke_digests.json
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from psxavenc_tpu import api as japi  # noqa: E402
from psxavenc_tpu import cli as jcli  # noqa: E402
from psxavenc_tpu import libpsxav as jlp  # noqa: E402
from psxavenc_tpu.models.bs_video import BsFrameEncoder  # noqa: E402
from psxavenc_tpu.utils import synth as jsynth  # noqa: E402
from psxavenc_tpu_torch.utils import synth as tsynth  # noqa: E402

CLI_CASES = cs.VIDEO_CLI_CASES + cs.AV_CLI_CASES + cs.BATCH_AUDIO_CASES
KEYS = [f"phase4_{label}" for _, label in cs.PHASE4_CODECS] + \
    [key for key, _, _ in CLI_CASES] + ["symbols_v2"] + \
    list(cs.LIBPSXAV_KEYS)


def _phase4_digest(codec):
    frames = cs.phase4_frames(np, tsynth)
    enc = BsFrameEncoder(codec, cs.W, cs.H)
    try:
        out = enc.encode_frames(list(frames), [cs.BUDGET] * cs.MAIN_FRAMES)
    finally:
        enc.close()
    return cs.sha256(b"".join(buf.tobytes() for buf, _ in out))


def _symbols_digest():
    frames = cs.symbols_frames(np, tsynth)
    out = japi.bs_encode_frames(
        jnp.asarray(frames), jnp.full((len(frames),), cs.BUDGET, jnp.int32),
        codec=0, width=cs.W, height=cs.H, pallas_sweep=False)
    return cs.symbols_digest(np, {k: np.asarray(v) for k, v in out.items()})


def _cli_digest(inputs, key, argv, src, out_dir):
    out = os.path.join(out_dir, cs.out_name(key))
    assert jcli.main(["-q", *argv, os.path.join(inputs, src), out]) == 0
    return cs.file_digest(out)


def compute(key, inputs, out_dir):
    """The JAX package's digest of smoke output ``key``."""
    if key == "symbols_v2":
        return _symbols_digest()
    if key in cs.LIBPSXAV_KEYS:
        return cs.sha256(cs.libpsxav_outputs(jlp, tsynth)[key])
    for codec, label in cs.PHASE4_CODECS:
        if key == f"phase4_{label}":
            return _phase4_digest(codec)
    for k, argv, src in CLI_CASES:
        if k == key:
            return _cli_digest(inputs, k, argv, src, out_dir)
    raise KeyError(key)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("smoke_inputs")
    cs.write_inputs(tsynth, str(d))
    return str(d)


@pytest.fixture(scope="module")
def committed():
    with open(cs.DIGESTS) as f:
        return json.load(f)


def test_digest_file_covers_every_smoke_output(committed):
    assert sorted(committed) == sorted(KEYS)


@pytest.mark.parametrize("key", KEYS)
def test_digest_is_the_jax_packages(key, inputs, committed, tmp_path):
    assert compute(key, inputs, str(tmp_path)) == committed[key]


def test_port_synth_writes_the_jax_inputs(inputs, tmp_path):
    cs.write_inputs(jsynth, str(tmp_path))
    for name in sorted(os.listdir(inputs)):
        got = pathlib.Path(inputs, name).read_bytes()
        assert got == (tmp_path / name).read_bytes(), name


def test_port_synth_gives_the_jax_arrays():
    np.testing.assert_array_equal(cs.phase4_frames(np, tsynth),
                                  cs.phase4_frames(np, jsynth))
    np.testing.assert_array_equal(
        cs.smoke_frames(np, tsynth, 16, seed=14, noise_every=0),
        cs.smoke_frames(np, jsynth, 16, seed=14, noise_every=0))
    for got, want in zip(cs.adpcm_units(np, tsynth, 600, 12),
                         cs.adpcm_units(np, jsynth, 600, 12)):
        np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ins = os.path.join(tmp, "in")
        os.mkdir(ins)
        cs.write_inputs(tsynth, ins)
        digests = {k: compute(k, ins, tmp) for k in KEYS}
    print(json.dumps(digests, indent=1, sort_keys=True))
