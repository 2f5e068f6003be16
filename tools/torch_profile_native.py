#!/usr/bin/env python
"""Stage timing for the port's native C++ tiers (native/psxav_native.cpp).

Builds a standalone instrumented binary that #includes the port's
psxav_native.cpp and times the video encoder's stages (rearrange+FDCT,
ladder-LB eval, exact eval, emission+pack, full frame) and the ADPCM unit
encoder on one core, on the pathological all-noise frame (the worst case
for the LB-to-exact gap); then times the loaded library as the encoders
call it (``native/tiers.py``): BS v2 320x240 frames/s and ADPCM units/s
over the host's cores. Ports tools/profile_native.py of psxavenc_tpu.

Usage: python tools/torch_profile_native.py [--frames N] [--threads N]
"""

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "psxavenc_tpu_torch" / "native" / "psxav_native.cpp"
BUILD = REPO / "psxavenc_tpu_torch" / "build"

HARNESS = r"""
#include <chrono>
#include <cstdio>
#include <random>
#include <vector>
#include "%SRC%"
using clk = std::chrono::steady_clock;
static double ms(clk::time_point a, clk::time_point b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
}
int main() {
    const int W = 320, H = 240;
    const long nb = (W/16)*(H/16)*6, budget = 18144;
    const long cap = (budget - 8) / 2;
    bs_luts_init();
    std::mt19937 rng(3);
    std::vector<uint8_t> frame(W*H*3/2);
    for (long i = 0; i < (long)frame.size(); i++)
        frame[i] = (uint8_t)((i %% 251) ^ (rng() & 31));
    std::vector<int16_t> czz(nb*64);
    std::vector<uint8_t> dcb(nb, 10);
    std::vector<uint32_t> dcc(nb, 0);
    std::vector<uint16_t> words(cap);
    int32_t sc, tb, nz; bs_seed seed; bs_scratch scr; scr.reserve(nb);
    const int R = 50;

    auto t0 = clk::now();
    for (int r = 0; r < R; r++) {
        seed = bs_seed{};
        bs_encode_one_frame(frame.data(), W, H, 0, budget, cap,
            words.data(), &sc, &tb, &nz, czz.data(), dcb.data(),
            dcc.data(), &seed, &scr);
    }
    auto t1 = clk::now();
    printf("video full (cold seed):  %%7.3f ms/frame  scale=%%d\n",
           ms(t0,t1)/R, sc);
    t0 = clk::now();
    for (int r = 0; r < R; r++)
        bs_encode_one_frame(frame.data(), W, H, 0, budget, cap,
            words.data(), &sc, &tb, &nz, czz.data(), dcb.data(),
            dcc.data(), &seed, &scr);
    t1 = clk::now();
    printf("video full (warm seed):  %%7.3f ms/frame\n", ms(t0,t1)/R);

    t0 = clk::now();
    for (int r = 0; r < R; r++)
        bs_frame_coefs(frame.data(), W, H, czz.data());
    t1 = clk::now();
    printf("coefs (rearrange+FDCT+zz): %%5.3f ms/frame\n", ms(t0,t1)/R);

    long thr = 16*cap - (10*nb + 2*nb + 10);
    t0 = clk::now();
    volatile bool f = false;
    for (int r = 0; r < R; r++) f = bs_lb_feasible(czz.data(), nb, sc, thr);
    t1 = clk::now();
    printf("ladder-LB eval:          %%7.3f ms  (feasible=%%d)\n",
           ms(t0,t1)/R, (int)f);
    long nzv = 0;
    t0 = clk::now();
    for (int r = 0; r < R; r++)
        (void)bs_exact_ac_bits(czz.data(), nb, sc, 1L<<40, &nzv);
    t1 = clk::now();
    printf("exact eval:              %%7.3f ms  (nz=%%ld)\n",
           ms(t0,t1)/R, nzv);
    (void)bs_exact_ac_bits_keys(czz.data(), nb, sc, 1L<<40, &nzv,
                                scr.keys_wk.data(), scr.kcnt_wk.data());
    t0 = clk::now();
    for (int r = 0; r < R; r++)
        bs_frame_emit(scr.keys_wk.data(), scr.kcnt_wk.data(), nb, 0,
                      dcb.data(), dcc.data(), words.data(), cap);
    t1 = clk::now();
    printf("emit+pack (key replay):  %%7.3f ms\n", ms(t0,t1)/R);

    // ADPCM unit encoder throughput (B rows x T units).
    const long B = 64, T = 500;
    std::vector<int16_t> units(B*T*28);
    int32_t acc = 0;
    for (long i = 0; i < (long)units.size(); i++) {
        acc += (int32_t)(rng() %% 1601) - 800;
        if (acc > 32767) acc = 32767;
        if (acc < -32768) acc = -32768;
        units[i] = (int16_t)acc;
    }
    std::vector<int32_t> limits(B*T, 28), st(B*2, 0);
    std::vector<uint8_t> hdrs(B*T), nibs(B*T*28);
    std::vector<int32_t> s1(B*T), s2(B*T);
    t0 = clk::now();
    psxn_adpcm_encode_units(units.data(), limits.data(), st.data(),
        hdrs.data(), nibs.data(), s1.data(), s2.data(), B, T, 5, 12);
    t1 = clk::now();
    printf("adpcm unit encoder:      %%7.1f Msamples/s\n",
           B*T*28 / ms(t0,t1) / 1e3);
    return 0;
}
"""



def harness():
    """Build and run the one-core stage harness; returns its exit code."""
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as td:
        cpp = pathlib.Path(td) / "prof.cpp"
        exe = pathlib.Path(td) / "prof"
        cpp.write_text(HARNESS.replace("%SRC%", str(SRC))
                       .replace("%%", "%"))
        subprocess.run(["g++", "-O3", "-std=c++17", "-march=native",
                        "-pthread", str(cpp), "-o", str(exe)], check=True)
        return subprocess.run([str(exe)]).returncode


def library(n_frames, n_threads):
    """The loaded library over the host's cores, as the encoders call it."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.utils import synth

    w, h, budget = 320, 240, 18144
    rng = np.random.default_rng(3)
    frames = []
    for i, (y, cb, cr) in enumerate(synth.rand_frames(w, h, n_frames,
                                                      seed=14)):
        if i % 8 == 7:
            frames.append(rng.integers(0, 256, w * h * 3 // 2)
                          .astype(np.uint8))
            continue
        c = np.stack([cr.reshape(h // 2, w // 2),
                      cb.reshape(h // 2, w // 2)], axis=-1).reshape(-1)
        frames.append(np.concatenate([y, c]).astype(np.uint8))
    frames = np.stack(frames)
    budgets = np.full(n_frames, budget, np.int32)
    tiers.lib()
    for codec, label in ((0, "v2"), (1, "v3"), (2, "v3dc")):
        t0 = time.perf_counter()
        out = tiers.bs_encode_frames(frames, budgets, codec=codec, width=w,
                                     height=h,
                                     capacity_words=(budget - 8 + 1) // 2,
                                     n_threads=n_threads)
        secs = time.perf_counter() - t0
        print(f"library {label} {w}x{h}: {n_frames / secs:8.1f} frames/s "
              f"on {n_threads} threads (video, every eighth frame noise; "
              f"mean scale {out['scale'].mean():.2f})")
    units = rng.integers(-20000, 20000, (64, 2000, 28)).astype(np.int16)
    lim = np.full((64, 2000), 28, np.int32)
    zero = np.zeros(64, np.int32)
    for fc, sr in ((5, 12), (4, 12), (4, 8)):
        t0 = time.perf_counter()
        tiers.adpcm_encode_units(units, lim, zero, zero, fc, sr)
        secs = time.perf_counter() - t0
        rate = units.shape[0] * units.shape[1] / secs
        print(f"library adpcm ({fc}, {sr}): {rate:,.0f} units/s over the "
              f"host's threads (64 streams x 2,000 units)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=256)
    parser.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = parser.parse_args()
    rc = harness()
    if rc:
        return rc
    print(f"host: {os.cpu_count()} cores")
    library(args.frames, args.threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
