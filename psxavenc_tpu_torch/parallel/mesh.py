"""Multi-device batch split: the batch axis over a list of torch devices.

Counterpart of ``psxavenc_tpu/parallel/mesh.py``. The encoder's work is
independent across frames and streams (codec state threads only along
time within a stream), so a batch splits into equal shards, one a device,
with no collective on the compute path. Where the JAX module declares
shardings over a device mesh and lets jit move the data, a step here
takes an explicit list of devices, copies shard i of every input to
device i, runs the single-device API on it and concatenates the outputs
on the first device; ``encode_step_sharded``'s statistics are summed
after that gather, which is what the JAX ``psum`` gives. A step takes
the whole batch; ``shard_batch`` gives the shards themselves, each on its
device, as the JAX module's ``shard_batch`` places a sharded array.

On CUDA each shard runs on a stream of its own on its own device. The
shard streams wait for the caller's current stream before they read the
inputs, and the caller's stream waits for them before the gather, so a
step is ordered like any other work on the caller's stream. The list may
hold one device more than once (the CPU tests; a host with one card):
the shards then share it, each on its own stream.

A batch that does not divide over the devices raises; callers pad, as in
the JAX package (``models/bs_video.py``).
"""

import torch

from .. import api
from ..utils import spans


def device_list(device):
    """One device or a sequence of devices -> a list of torch.device (a
    card named without an index is the current one)."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    if not devices:
        raise ValueError("no device given")
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def make_mesh(devices=None):
    """The devices of a split: ``devices``, or every visible card."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    return device_list(devices)


def _shard_sizes(n_devices, batch):
    if batch % n_devices:
        raise ValueError(f"a batch of {batch} does not divide over "
                         f"{n_devices} devices; pad it to a multiple")
    return [batch // n_devices] * n_devices


def shard_batch(devices, tensor):
    """``tensor``'s leading (batch) axis cut into one equal shard per
    device of ``devices`` (the shard sizes of a split step), shard i
    copied to device i -> the list of shards. A batch that does not
    divide raises."""
    devices = make_mesh(devices)
    tensor = torch.as_tensor(tensor)
    sizes = _shard_sizes(len(devices), tensor.shape[0])
    parts = torch.split(tensor, sizes)
    for part, dev in zip(parts, devices):
        spans.count_h2d(part, dev)
    return [part.to(dev) for part, dev in zip(parts, devices)]


def _tensors(out):
    return list(out.values()) if isinstance(out, dict) else list(out)


def _rebuild(out, tensors):
    if isinstance(out, dict):
        return dict(zip(out, tensors))
    return tuple(tensors)


class _Split:
    """``fn`` over the leading (batch) axis of its tensor arguments, split
    into one equal shard per device of ``devices``; the outputs (a dict or
    a tuple of tensors, batch-major) are concatenated on the first
    device."""

    def __init__(self, devices, fn):
        self.devices = make_mesh(devices)
        self.fn = fn
        self._streams = None

    def shard_shapes(self, batch):
        """The batch size of each shard of a ``batch``-row call."""
        return _shard_sizes(len(self.devices), batch)

    def __call__(self, *args):
        args = [torch.as_tensor(a) for a in args]
        batch = args[0].shape[0]
        if any(a.shape[0] != batch for a in args):
            raise ValueError("the arguments' batch sizes differ: "
                             f"{[a.shape[0] for a in args]}")
        b = self.shard_shapes(batch)[0]
        home = self.devices[0]
        on_cuda = home.type == "cuda"
        if on_cuda:
            caller = torch.cuda.current_stream(home)
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device=d)
                                 for d in self.devices]
        outs = []
        for i, dev in enumerate(self.devices):
            parts = [a[i * b:(i + 1) * b] for a in args]
            for p in parts:
                spans.count_h2d(p, dev)
            if on_cuda:
                stream = self._streams[i]
                stream.wait_stream(caller)
                with torch.cuda.stream(stream):
                    for p in parts:
                        if p.device == dev:     # read on this stream
                            p.record_stream(stream)
                    out = self.fn(*[p.to(dev, non_blocking=True)
                                    for p in parts])
                    # Copies to the first device run on this stream and
                    # make the caller's stream wait for them.
                    moved = [t.to(home, non_blocking=True)
                             for t in _tensors(out)]
                for t in moved:
                    if t.device == dev:         # made on this stream
                        t.record_stream(caller)
            else:
                out = self.fn(*[p.to(dev) for p in parts])
                moved = [t.to(home) for t in _tensors(out)]
            shapes = [t.shape[0] for t in moved]
            if any(s != b for s in shapes):
                raise RuntimeError(f"shard {i} on {dev} returned batches "
                                   f"{shapes}, not {b}")
            outs.append((out, moved))
        if on_cuda:
            for stream in self._streams:
                caller.wait_stream(stream)
        cols = zip(*(moved for _, moved in outs))
        return _rebuild(outs[0][0], [torch.cat(col) for col in cols])


def packed_video_step(devices, *, codec, width, height, capacity_words,
                      kernel_sweep=True, packer=None, k1_stats=False):
    """The split video encoder: ``step(frames, budgets)`` runs
    ``api.bs_encode_frames_packed`` on each shard of the (B, w*h*3/2)
    uint8 frames and (B,) int32 budgets (on any device; B a multiple of
    the device count) and returns its dict on the first device, equal to
    the single-device call (``k1_stats`` as there)."""
    def fn(frames, budgets):
        return api.bs_encode_frames_packed(
            frames, budgets, codec=codec, width=width, height=height,
            capacity_words=capacity_words, kernel_sweep=kernel_sweep,
            packer=packer, k1_stats=k1_stats)
    return _Split(devices, fn)


def unit_encode_step(devices, *, filter_count, shift_range):
    """The split ADPCM unit encoder for file batches: ``step(units,
    limits, prev1, prev2)`` on (B, T, 28) units, (B, T) limits and (B,)
    states -> (headers (B, T), sample values (B, T, 28), s1, s2 (B, T)),
    K5 on each shard (the batch runner's grouped audio encode)."""
    def fn(units, limits, prev1, prev2):
        return api._adpcm_batch(units, limits, prev1, prev2, filter_count,
                                shift_range)
    return _Split(devices, fn)


def encode_step_sharded(devices, *, codec, width, height):
    """The batched A/V step split over ``devices``: ``step(frames,
    budgets, units, limits, prev1, prev2)`` -> (codes, bits, headers,
    sample values, stats), stats the int32 sums [total_bits, scale,
    headers & 0xF] over the whole batch (the JAX ``psum``). Frames and
    unit streams share the batch axis, as in the JAX step."""
    def fn(frames, budgets, units, limits, prev1, prev2):
        video = api.bs_encode_frames(frames, budgets, codec=codec,
                                     width=width, height=height)
        headers, values, _, _ = api.spu_encode_batch(units, limits, prev1,
                                                     prev2)
        return (video["codes"], video["bits"], headers, values,
                video["total_bits"], video["scale"])

    split = _Split(devices, fn)

    def step(*args):
        codes, bits, headers, values, total_bits, scale = split(*args)
        stats = torch.stack([total_bits.sum(), scale.sum(),
                             (headers.to(torch.int32) & 0xF).sum()])
        return codes, bits, headers, values, stats.to(torch.int32)

    return step
