// Native host tiers of psxavenc_tpu_torch: the ADPCM unit encoder, the BS
// 16-bit little-endian bit packer (behavior of psxavenc/mdec.c:321-385)
// and the BS video frame encoder, bit-exact with the card's kernels. This
// is the port's copy of the encoder entry points of
// psxavenc_tpu/native/psxav_native.cpp and everything they call, with no
// arithmetic changed; the CD sector, EDC and XA code lives once in the
// port, in psxav_host.cpp.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX2__) && defined(__BMI2__)
#include <immintrin.h>
#define BS_HAVE_AVX2 1
#endif

extern "C" {

// ------------------------------------------------------ ADPCM unit encoder

// Host fallback for the ADPCM candidate search when no TPU (Mosaic
// kernel) is available: same semantics as ops/adpcm.py::encode_unit —
// the reference's candidate order (filter-major, shift ascending,
// adpcm.c:142-191), strict `>` first-best ties, exact uint64 MSE, and
// decoded-sample state threading across units. The XLA formulation of
// the 28-step recurrence is dispatch-bound off-TPU (~0.5 Msamples/s on
// CPU); this plain loop exceeds the reference C encoder's throughput.

static const int32_t adpcm_k1[5] = {0, 60, 115, 98, 122};
static const int32_t adpcm_k2[5] = {0, 0, -52, -55, -60};

static inline int32_t adpcm_predict(int32_t k1, int32_t k2, int32_t p1,
                                    int32_t p2) {
    return (k1 * p1 + k2 * p2 + 32) >> 6;
}

// Encode B independent unit streams: per row, T units of 28 samples
// with per-unit limits (limit <= 0 zeroes the whole unit, >= 28 keeps
// all), threading (prev1, prev2) decoder state across units. Outputs
// headers (B,T), nibble values (B,T,28) and the post-unit decoder
// states s1/s2 (B,T) (callers slice the state at any unit, matching
// encode_units_scan's per-unit state returns).
//
// All (filter, shift) candidates run as LANES of fixed-width arrays
// (the CPU analog of the Pallas kernel's sublane layout,
// ops/adpcm_pallas.py): the 28-step decode recurrence executes once
// per unit over 16 int32 lanes instead of once per candidate, and the
// fixed-trip inner loops auto-vectorize (variable per-lane shifts are
// vpsravd/vpsllvd). Same exactness devices as the kernel: the hoisted
// shift reformulation ((s-pred+bias)>>rc with rc = range-sh, exact for
// every sh in [0, range]) and the uint32 wraparound + carry-count MSE
// (err^2 < 2^32 per step). Candidate order and strict-< first-best
// ties match adpcm.c:142-191.
#define ADPCM_VL 16

void psxn_adpcm_encode_units(const int16_t *units, const int32_t *limits,
                             const int32_t *state12, uint8_t *headers,
                             uint8_t *nibbles, int32_t *s1_out,
                             int32_t *s2_out, long B, long T,
                             int filter_count, int shift_range) {
    const int32_t sample_mask = 0xFFFF >> shift_range;
    const int32_t min_e = -0x8000 >> shift_range;
    const int32_t max_e = 0x7FFF >> shift_range;
    const int C = filter_count * 3;            // <= 15

    // Rows are independent streams (state threads along T only), so
    // on multicore hosts they fan out across threads; the per-row body
    // is unchanged and order-free.
    long hw = (long)std::thread::hardware_concurrency();
    long nth = hw > 0 ? (hw < B ? hw : B) : 1;
    if (nth > 1) {
        std::vector<std::thread> ths;
        for (long t = 0; t < nth; t++)
            ths.emplace_back([&, t]() {
                for (long b = t; b < B; b += nth)
                    psxn_adpcm_encode_units(
                        units + b * T * 28, limits + b * T,
                        state12 + b * 2, headers + b * T,
                        nibbles + b * T * 28, s1_out + b * T,
                        s2_out + b * T, 1, T, filter_count,
                        shift_range);
            });
        for (auto &th : ths) th.join();
        return;
    }

    for (long b = 0; b < B; b++) {
        int32_t prev1 = state12[b * 2], prev2 = state12[b * 2 + 1];
        for (long t = 0; t < T; t++) {
            const int16_t *su = units + (b * T + t) * 28;
            int32_t lim = limits[b * T + t];
            int32_t raw[28];
            for (int i = 0; i < 28; i++)
                raw[i] = (i < lim) ? (int32_t)su[i] : 0;

            // find_min_shift per filter: residuals with RAW history
            // (no quantization feedback), smallest right-shift keeping
            // them in range with one-step clip allowed (adpcm.c:39-79).
            // Filters ride 8 lanes; the raw history (p1, p2) is shared,
            // so the scan body is pure elementwise ops.
            int32_t s_min8[8], s_max8[8], k1_8[8], k2_8[8];
            for (int f = 0; f < 8; f++) {
                s_min8[f] = 0;
                s_max8[f] = 0;
                k1_8[f] = adpcm_k1[f < filter_count ? f : 0];
                k2_8[f] = adpcm_k2[f < filter_count ? f : 0];
            }
            {
                int32_t p1 = prev1, p2 = prev2;
                for (int i = 0; i < 28; i++) {
                    for (int f = 0; f < 8; f++) {
                        int32_t r = raw[i] -
                            ((k1_8[f] * p1 + k2_8[f] * p2 + 32) >> 6);
                        if (r < s_min8[f]) s_min8[f] = r;
                        if (r > s_max8[f]) s_max8[f] = r;
                    }
                    p2 = p1;
                    p1 = raw[i];
                }
            }
            int min_shift_f[5];
            for (int f = 0; f < filter_count; f++) {
                int right_shift = 0;
                while (right_shift < shift_range &&
                       ((s_max8[f] >> right_shift) > max_e ||
                        (s_min8[f] >> right_shift) < min_e))
                    right_shift++;
                min_shift_f[f] = shift_range - right_shift;
            }

            // Candidate lanes (filter-major, shift ascending), padded
            // to ADPCM_VL with candidate-0 duplicates.
            int32_t k1c[ADPCM_VL], k2c[ADPCM_VL], shc[ADPCM_VL];
            for (int c = 0; c < ADPCM_VL; c++) {
                if (c < C) {
                    int f = c / 3, d = c % 3 - 1;
                    int sh = min_shift_f[f] + d;
                    if (sh < 0) sh = 0;
                    if (sh > shift_range) sh = shift_range;
                    k1c[c] = adpcm_k1[f];
                    k2c[c] = adpcm_k2[f];
                    shc[c] = sh;
                } else {
                    k1c[c] = k1c[0];
                    k2c[c] = k2c[0];
                    shc[c] = shc[0];
                }
            }
            int32_t rc[ADPCM_VL], bias[ADPCM_VL];
            for (int c = 0; c < ADPCM_VL; c++) {
                rc[c] = shift_range - shc[c];
                bias[c] = (1 << rc[c]) >> 1;
            }

            int32_t a1[ADPCM_VL], a2[ADPCM_VL];
            uint32_t mse_lo[ADPCM_VL];
            int32_t mse_hi[ADPCM_VL];
            int32_t nib[28][ADPCM_VL];
            for (int c = 0; c < ADPCM_VL; c++) {
                a1[c] = prev1;
                a2[c] = prev2;
                mse_lo[c] = 0;
                mse_hi[c] = 0;
            }
            for (int i = 0; i < 28; i++) {
                const int32_t s = raw[i];
                for (int c = 0; c < ADPCM_VL; c++) {
                    int32_t pred = (k1c[c] * a1[c] + k2c[c] * a2[c] + 32)
                                   >> 6;
                    int32_t enc = (s - pred + bias[c]) >> rc[c];
                    if (enc < min_e) enc = min_e;
                    if (enc > max_e) enc = max_e;
                    // enc stays SIGNED through decode: enc << rc is the
                    // sign-extended reconstruction for in-range enc
                    // (the nibble masks on at extraction).
                    int32_t dec =
                        (int32_t)((uint32_t)enc << rc[c]) + pred;
                    if (dec < -0x8000) dec = -0x8000;
                    if (dec > 0x7FFF) dec = 0x7FFF;
                    int32_t err = dec - s;
                    uint32_t sq = (uint32_t)(err * err);  // < 2^32 exact
                    mse_lo[c] += sq;
                    mse_hi[c] += mse_lo[c] < sq;          // carry
                    nib[i][c] = enc;
                    a2[c] = a1[c];
                    a1[c] = dec;
                }
            }

            // Fold lanes 0..C-1 in candidate order, strictly-better
            // updates (lexicographic (hi, lo) = exact uint64 compare).
            int best = 0;
            for (int c = 1; c < C; c++)
                if (mse_hi[c] < mse_hi[best] ||
                    (mse_hi[c] == mse_hi[best] &&
                     mse_lo[c] < mse_lo[best]))
                    best = c;

            headers[b * T + t] =
                (uint8_t)((shc[best] & 0x0F) | ((best / 3) << 4));
            uint8_t *nb = nibbles + (b * T + t) * 28;
            for (int i = 0; i < 28; i++)
                nb[i] = (uint8_t)(nib[i][best] & sample_mask);
            prev1 = a1[best];
            prev2 = a2[best];
            s1_out[b * T + t] = prev1;
            s2_out[b * T + t] = prev2;
        }
    }
}

// ------------------------------------------------------------- BS bit packer

// Pack a symbol stream into the BS frame bitstream: 16-bit groups filled
// MSB-first, flushed as little-endian byte pairs starting at output offset 8
// (mdec.c:321-385). Symbols longer than 16 bits emit their high bits first.
//
// codes[i] carries the code value, lens[i] its bit length (0 = skip).
// Returns bytes_used (still to be rounded up to a multiple of 4 by the
// caller) or -1 if max_size would be exceeded (mdec.c:324-325 bail-out).
long psxn_bs_pack(const uint32_t *codes, const uint8_t *lens, long n,
                  uint8_t *out, long max_size) {
    long bytes_used = 8;
    uint16_t value = 0;
    int bits_left = 16;

    for (long i = 0; i < n; i++) {
        int bits = lens[i];
        if (bits == 0) continue;
        uint32_t val = codes[i];
        // Split >16-bit codes exactly like the recursive path in
        // encode_bits (mdec.c:340-346).
        for (int part = 0; part < 2; part++) {
            int pbits;
            uint32_t pval;
            if (bits > 16) {
                if (part == 0) { pbits = bits - 16; pval = val >> 16; }
                else { pbits = 16; pval = val & 0xFFFF; }
            } else {
                if (part == 0) { pbits = bits; pval = val; }
                else break;
            }
            if (bits_left == 0) {
                out[bytes_used++] = (uint8_t)value;
                if (bytes_used >= max_size) return -1;
                out[bytes_used++] = (uint8_t)(value >> 8);
                value = 0;
                bits_left = 16;
            }
            while (pbits > bits_left) {
                value |= (uint16_t)(pval >> (pbits - bits_left));
                pbits -= bits_left;
                pval &= (1u << pbits) - 1;
                out[bytes_used++] = (uint8_t)value;
                if (bytes_used >= max_size) return -1;
                out[bytes_used++] = (uint8_t)(value >> 8);
                value = 0;
                bits_left = 16;
            }
            if (pbits >= 1) {
                value |= (uint16_t)(pval << (bits_left - pbits));
                bits_left -= pbits;
            }
        }
    }
    // Final flush (mdec.c:716): write the partial word if any bits were
    // placed since the last flush.
    if (bits_left < 16) {
        out[bytes_used++] = (uint8_t)value;
        if (bytes_used >= max_size) return -1;
        out[bytes_used++] = (uint8_t)(value >> 8);
    }
    return bytes_used;
}

// --------------------------------------------------- BS frame encoder (host)

// Host fallback tier for the whole BS video frame pipeline (the video
// analog of psxn_adpcm_encode_units): NV21 pixels in, packed bitstream
// words + scale/total_bits/nz metadata out, bit-identical to the device
// pipeline (api.bs_encode_frames_packed). The XLA formulation is
// dispatch-bound off-TPU (~3 fps on this host vs the reference binary's
// ~150); this plain scalar pipeline exceeds the reference by computing
// the FDCT once per frame and proving scales unfit with the same
// monotone ladder lower bound the Mosaic select kernel uses
// (ops/bs_pallas.py::ladder_lb) instead of re-encoding per retry
// (mdec.c:663-723 re-runs the whole frame per scale).

// PSX default quantization matrix (mdec.c:189-198) and inverse zigzag
// (mdec.c:213-222) — format constants.
static const int32_t bs_quant[64] = {
    2, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83,
};
static const uint8_t bs_zagzig[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

// MDEC AC Huffman table: {run, |level|, prefix_bits, prefix_value}
// (the same code set as ops/bs.py AC_TABLE / mdec.c:39-157 — the spec).
struct bs_ac_entry { uint8_t run, level, pbits; uint16_t pval; };
static const bs_ac_entry bs_ac_table[] = {
    {0, 1, 2, 0x3}, {1, 1, 3, 0x3}, {0, 2, 4, 0x4}, {2, 1, 4, 0x5},
    {0, 3, 5, 0x05}, {4, 1, 5, 0x06}, {3, 1, 5, 0x07},
    {7, 1, 6, 0x04}, {6, 1, 6, 0x05}, {1, 2, 6, 0x06}, {5, 1, 6, 0x07},
    {2, 2, 7, 0x04}, {9, 1, 7, 0x05}, {0, 4, 7, 0x06}, {8, 1, 7, 0x07},
    {13, 1, 8, 0x20}, {0, 6, 8, 0x21}, {12, 1, 8, 0x22},
    {11, 1, 8, 0x23}, {3, 2, 8, 0x24}, {1, 3, 8, 0x25},
    {0, 5, 8, 0x26}, {10, 1, 8, 0x27},
    {16, 1, 10, 0x008}, {5, 2, 10, 0x009}, {0, 7, 10, 0x00A},
    {2, 3, 10, 0x00B}, {1, 4, 10, 0x00C}, {15, 1, 10, 0x00D},
    {14, 1, 10, 0x00E}, {4, 2, 10, 0x00F},
    {0, 11, 12, 0x010}, {8, 2, 12, 0x011}, {4, 3, 12, 0x012},
    {0, 10, 12, 0x013}, {2, 4, 12, 0x014}, {7, 2, 12, 0x015},
    {21, 1, 12, 0x016}, {20, 1, 12, 0x017}, {0, 9, 12, 0x018},
    {19, 1, 12, 0x019}, {18, 1, 12, 0x01A}, {1, 5, 12, 0x01B},
    {3, 3, 12, 0x01C}, {0, 8, 12, 0x01D}, {6, 2, 12, 0x01E},
    {17, 1, 12, 0x01F},
    {10, 2, 13, 0x0010}, {9, 2, 13, 0x0011}, {5, 3, 13, 0x0012},
    {3, 4, 13, 0x0013}, {2, 5, 13, 0x0014}, {1, 7, 13, 0x0015},
    {1, 6, 13, 0x0016}, {0, 15, 13, 0x0017}, {0, 14, 13, 0x0018},
    {0, 13, 13, 0x0019}, {0, 12, 13, 0x001A}, {26, 1, 13, 0x001B},
    {25, 1, 13, 0x001C}, {24, 1, 13, 0x001D}, {23, 1, 13, 0x001E},
    {22, 1, 13, 0x001F},
    {0, 31, 14, 0x0010}, {0, 30, 14, 0x0011}, {0, 29, 14, 0x0012},
    {0, 28, 14, 0x0013}, {0, 27, 14, 0x0014}, {0, 26, 14, 0x0015},
    {0, 25, 14, 0x0016}, {0, 24, 14, 0x0017}, {0, 23, 14, 0x0018},
    {0, 22, 14, 0x0019}, {0, 21, 14, 0x001A}, {0, 20, 14, 0x001B},
    {0, 19, 14, 0x001C}, {0, 18, 14, 0x001D}, {0, 17, 14, 0x001E},
    {0, 16, 14, 0x001F},
    {0, 40, 15, 0x0010}, {0, 39, 15, 0x0011}, {0, 38, 15, 0x0012},
    {0, 37, 15, 0x0013}, {0, 36, 15, 0x0014}, {0, 35, 15, 0x0015},
    {0, 34, 15, 0x0016}, {0, 33, 15, 0x0017}, {0, 32, 15, 0x0018},
    {1, 14, 15, 0x0019}, {1, 13, 15, 0x001A}, {1, 12, 15, 0x001B},
    {1, 11, 15, 0x001C}, {1, 10, 15, 0x001D}, {1, 9, 15, 0x001E},
    {1, 8, 15, 0x001F},
    {1, 18, 16, 0x0010}, {1, 17, 16, 0x0011}, {1, 16, 16, 0x0012},
    {1, 15, 16, 0x0013}, {6, 3, 16, 0x0014}, {16, 2, 16, 0x0015},
    {15, 2, 16, 0x0016}, {14, 2, 16, 0x0017}, {13, 2, 16, 0x0018},
    {12, 2, 16, 0x0019}, {11, 2, 16, 0x001A}, {31, 1, 16, 0x001B},
    {30, 1, 16, 0x001C}, {29, 1, 16, 0x001D}, {28, 1, 16, 0x001E},
    {27, 1, 16, 0x001F},
};

// BS v3 DC delta prefix trees (mdec.c:159-187): {prefix_bits,
// prefix_value, delta_bits}.
struct bs_dc_entry { uint8_t pbits; uint8_t pval; uint8_t dbits; };
static const bs_dc_entry bs_dc_c[8] = {
    {2, 0x1, 0}, {2, 0x2, 1}, {3, 0x6, 2}, {4, 0xE, 3},
    {5, 0x1E, 4}, {6, 0x3E, 5}, {7, 0x7E, 6}, {8, 0xFE, 7}};
static const bs_dc_entry bs_dc_y[8] = {
    {2, 0x0, 0}, {2, 0x1, 1}, {3, 0x5, 2}, {3, 0x6, 3},
    {4, 0xE, 4}, {5, 0x1E, 5}, {6, 0x3E, 6}, {7, 0x7E, 7}};

// 64K-entry AC (bits, code) LUTs keyed by (run<<10)|(level&0x3FF) and
// (2, 512) DC LUTs per tree — the host mirrors of ops/bs.py's
// _build_ac_luts/_build_dc_luts (gathers are cheap on CPU; the closed
// forms exist for the TPU, where they replace these same tables).
static uint8_t bs_ac_bits[0x10000];
static uint32_t bs_ac_code[0x10000];
static uint8_t bs_dc_bits[2][512];
static uint32_t bs_dc_code[2][512];
// std::once_flag, not a plain bool: psxn_bs_encode_frames may be entered
// from multiple host threads, and an unordered ready-flag store could be
// observed before the table writes (C++ data race).
static std::once_flag bs_luts_once;

static void bs_luts_init() {
    for (uint32_t key = 0; key < 0x10000; key++) {
        bs_ac_bits[key] = 22;                 // escape: 000001 + raw 16
        bs_ac_code[key] = (1u << 16) | key;
    }
    for (const bs_ac_entry &e : bs_ac_table) {
        for (int sign = 0; sign < 2; sign++) {
            int32_t val = sign ? -(int32_t)e.level : (int32_t)e.level;
            uint32_t key = ((uint32_t)e.run << 10) | ((uint32_t)val & 0x3FF);
            bs_ac_bits[key] = (uint8_t)(e.pbits + 1);
            bs_ac_code[key] = ((uint32_t)e.pval << 1) | (uint32_t)sign;
        }
    }
    for (int idx = 0; idx < 2; idx++) {       // 0 = chroma tree, 1 = luma
        const bs_dc_entry *tab = idx ? bs_dc_y : bs_dc_c;
        bs_dc_bits[idx][0] = idx ? 3 : 2;     // delta 0 special
        bs_dc_code[idx][0] = idx ? 4 : 0;
        for (int k = 0; k < 8; k++) {
            int db = tab[k].dbits;
            int n_bits = tab[k].pbits + 1 + db;
            int pos_offset = 1 << db;
            int neg_offset = pos_offset * 2 - 1;
            for (int j = 0; j < (1 << db); j++) {
                int pos = (j + pos_offset) & 0x1FF;
                int neg = (j - neg_offset) & 0x1FF;
                uint32_t code = ((uint32_t)tab[k].pval << (db + 1)) |
                                (1u << db) | (uint32_t)j;
                bs_dc_bits[idx][pos] = (uint8_t)n_bits;
                bs_dc_code[idx][pos] = code;
                bs_dc_bits[idx][neg] = (uint8_t)n_bits;
                bs_dc_code[idx][neg] =
                    ((uint32_t)tab[k].pval << (db + 1)) | (uint32_t)j;
            }
        }
        // Unmapped delta -256 (reference UB, PARITY.md): -255's code.
        bs_dc_bits[idx][256] = bs_dc_bits[idx][257];
        bs_dc_code[idx][256] = bs_dc_code[idx][257];
    }
}

// islow FDCT, the same public Loeffler/Ligtenberg/Moshovitz algorithm as
// ops/fdct.py (FFmpeg jfdctint variant: CONST_BITS=13, PASS1_BITS=4,
// int16 pass-1 store) — bit-identical to the JAX implementation.
#define BS_CONST_BITS 13
#define BS_PASS1_BITS 4

static inline int32_t bs_descale(int32_t x, int n) {
    return (x + (1 << (n - 1))) >> n;
}
static inline int32_t bs_wrap16(int32_t x) {
    return (int32_t)(int16_t)(uint16_t)(uint32_t)x;
}
static inline int32_t bs_shl(int32_t x, int n) {
    return (int32_t)((uint32_t)x << n);   // defined for negative x too
}

static void bs_fdct_pass(int32_t *v, int stride, bool pass1) {
    int32_t d0 = v[0], d1 = v[stride], d2 = v[2 * stride],
            d3 = v[3 * stride], d4 = v[4 * stride], d5 = v[5 * stride],
            d6 = v[6 * stride], d7 = v[7 * stride];
    const int descale_bits =
        pass1 ? BS_CONST_BITS - BS_PASS1_BITS : BS_CONST_BITS + BS_PASS1_BITS;

    int32_t tmp0 = d0 + d7, tmp7 = d0 - d7;
    int32_t tmp1 = d1 + d6, tmp6 = d1 - d6;
    int32_t tmp2 = d2 + d5, tmp5 = d2 - d5;
    int32_t tmp3 = d3 + d4, tmp4 = d3 - d4;
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    int32_t out0, out4;
    if (pass1) {
        out0 = bs_shl(tmp10 + tmp11, BS_PASS1_BITS);
        out4 = bs_shl(tmp10 - tmp11, BS_PASS1_BITS);
    } else {
        out0 = bs_descale(tmp10 + tmp11, BS_PASS1_BITS);
        out4 = bs_descale(tmp10 - tmp11, BS_PASS1_BITS);
    }
    int32_t z1 = (tmp12 + tmp13) * 4433;           // FIX_0_541196100
    int32_t out2 = bs_descale(z1 + tmp13 * 6270, descale_bits);
    int32_t out6 = bs_descale(z1 - tmp12 * 15137, descale_bits);

    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6;
    int32_t z3 = tmp4 + tmp6;
    int32_t z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * 9633;                 // FIX_1_175875602

    int32_t t4 = tmp4 * 2446;                      // FIX_0_298631336
    int32_t t5 = tmp5 * 16819;                     // FIX_2_053119869
    int32_t t6 = tmp6 * 25172;                     // FIX_3_072711026
    int32_t t7 = tmp7 * 12299;                     // FIX_1_501321110
    z1 = z1 * -7373;                               // -FIX_0_899976223
    z2 = z2 * -20995;                              // -FIX_2_562915447
    z3 = z3 * -16069 + z5;                         // -FIX_1_961570560
    z4 = z4 * -3196 + z5;                          // -FIX_0_390180644

    int32_t out7 = bs_descale(t4 + z1 + z3, descale_bits);
    int32_t out5 = bs_descale(t5 + z2 + z4, descale_bits);
    int32_t out3 = bs_descale(t6 + z2 + z3, descale_bits);
    int32_t out1 = bs_descale(t7 + z1 + z4, descale_bits);

    if (pass1) {
        // The reference's pass-1 store is an int16 array; replicate the
        // wrap so out-of-range inputs degrade identically.
        v[0] = bs_wrap16(out0); v[stride] = bs_wrap16(out1);
        v[2 * stride] = bs_wrap16(out2); v[3 * stride] = bs_wrap16(out3);
        v[4 * stride] = bs_wrap16(out4); v[5 * stride] = bs_wrap16(out5);
        v[6 * stride] = bs_wrap16(out6); v[7 * stride] = bs_wrap16(out7);
    } else {
        v[0] = out0; v[stride] = out1;
        v[2 * stride] = out2; v[3 * stride] = out3;
        v[4 * stride] = out4; v[5 * stride] = out5;
        v[6 * stride] = out6; v[7 * stride] = out7;
    }
}

static void bs_fdct_block(int32_t d[64]) {
    for (int r = 0; r < 8; r++) bs_fdct_pass(d + 8 * r, 1, true);
    for (int c = 0; c < 8; c++) bs_fdct_pass(d + c, 8, false);
}

// SoA variant: 8 blocks ride the minor axis (lanes), the same layout
// the Pallas kernels use with blocks on lanes (ops/fdct.py fdct_rows).
// Every butterfly line is a fixed 8-int32 loop over distinct soa rows,
// which -O3 -march=native turns into single vector ops — no transposes
// needed. Bit-identical to bs_fdct_block per lane.
#define BS_SOA 8
typedef int32_t bs_vrow[BS_SOA];

static inline void bs_fdct_pass_soa(bs_vrow *v, int stride, bool pass1) {
    const int descale_bits =
        pass1 ? BS_CONST_BITS - BS_PASS1_BITS : BS_CONST_BITS + BS_PASS1_BITS;
    const int32_t drnd = 1 << (descale_bits - 1);
    const int32_t prnd = 1 << (BS_PASS1_BITS - 1);
    for (int b = 0; b < BS_SOA; b++) {
        int32_t d0 = v[0][b], d1 = v[stride][b], d2 = v[2 * stride][b],
                d3 = v[3 * stride][b], d4 = v[4 * stride][b],
                d5 = v[5 * stride][b], d6 = v[6 * stride][b],
                d7 = v[7 * stride][b];
        int32_t tmp0 = d0 + d7, tmp7 = d0 - d7;
        int32_t tmp1 = d1 + d6, tmp6 = d1 - d6;
        int32_t tmp2 = d2 + d5, tmp5 = d2 - d5;
        int32_t tmp3 = d3 + d4, tmp4 = d3 - d4;
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

        int32_t out0, out4;
        if (pass1) {
            out0 = bs_shl(tmp10 + tmp11, BS_PASS1_BITS);
            out4 = bs_shl(tmp10 - tmp11, BS_PASS1_BITS);
        } else {
            out0 = (tmp10 + tmp11 + prnd) >> BS_PASS1_BITS;
            out4 = (tmp10 - tmp11 + prnd) >> BS_PASS1_BITS;
        }
        int32_t z1 = (tmp12 + tmp13) * 4433;
        int32_t out2 = (z1 + tmp13 * 6270 + drnd) >> descale_bits;
        int32_t out6 = (z1 - tmp12 * 15137 + drnd) >> descale_bits;

        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6;
        int32_t z3 = tmp4 + tmp6;
        int32_t z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * 9633;
        int32_t t4 = tmp4 * 2446;
        int32_t t5 = tmp5 * 16819;
        int32_t t6 = tmp6 * 25172;
        int32_t t7 = tmp7 * 12299;
        z1 = z1 * -7373;
        z2 = z2 * -20995;
        z3 = z3 * -16069 + z5;
        z4 = z4 * -3196 + z5;
        int32_t out7 = (t4 + z1 + z3 + drnd) >> descale_bits;
        int32_t out5 = (t5 + z2 + z4 + drnd) >> descale_bits;
        int32_t out3 = (t6 + z2 + z3 + drnd) >> descale_bits;
        int32_t out1 = (t7 + z1 + z4 + drnd) >> descale_bits;

        if (pass1) {
            v[0][b] = bs_wrap16(out0);
            v[stride][b] = bs_wrap16(out1);
            v[2 * stride][b] = bs_wrap16(out2);
            v[3 * stride][b] = bs_wrap16(out3);
            v[4 * stride][b] = bs_wrap16(out4);
            v[5 * stride][b] = bs_wrap16(out5);
            v[6 * stride][b] = bs_wrap16(out6);
            v[7 * stride][b] = bs_wrap16(out7);
        } else {
            v[0][b] = out0;
            v[stride][b] = out1;
            v[2 * stride][b] = out2;
            v[3 * stride][b] = out3;
            v[4 * stride][b] = out4;
            v[5 * stride][b] = out5;
            v[6 * stride][b] = out6;
            v[7 * stride][b] = out7;
        }
    }
}

static void bs_fdct_soa8(bs_vrow soa[64]) {
    for (int r = 0; r < 8; r++) bs_fdct_pass_soa(soa + 8 * r, 1, true);
    for (int c = 0; c < 8; c++) bs_fdct_pass_soa(soa + c, 8, false);
}

// round(n/d) half away from zero, exact integers (mdec.c:438).
static inline int32_t bs_div_rounded(int32_t n, int32_t d) {
    int32_t an = n < 0 ? -n : n;
    int32_t q = (an + (d >> 1)) / d;
    return n < 0 ? -q : q;
}

// int16 wrap then clamp to [-0x200, +0x1FE] (mdec.c:257-267).
static inline int32_t bs_clamp_coeff(int32_t q) {
    int32_t w = bs_wrap16(q);
    if (w < -0x200) w = -0x200;
    if (w > 0x1FE) w = 0x1FE;
    return w;
}

// Per-block nonzero bitmask: bit i (1..63, raw zigzag index) set iff
// |czz[i]| >= threshold[i], i.e. the coefficient survives quantization
// at the scale the thresholds encode (a + d/2 >= d  <=>  a >= d - d/2).
// thrm1[i] holds threshold-1 as int16 (thresholds fit: d - d/2 <= 2615
// at s=63), thrm1[0] = INT16_MAX excludes the DC slot. The AVX2 path
// compares 16 lanes at a time and pext-compacts the movemask; the
// evals below then touch ONLY set bits — typical frames quantize
// ~90% of ACs to zero, so this is the difference between 113k scalar
// loop iterations per eval and ~5-15k.
static inline uint64_t bs_nz_mask64(const int16_t *blk,
                                    const int16_t *thrm1) {
#ifdef BS_HAVE_AVX2
    uint64_t mask = 0;
    for (int g = 0; g < 4; g++) {
        __m256i av = _mm256_abs_epi16(
            _mm256_loadu_si256((const __m256i *)(blk + g * 16)));
        __m256i tv = _mm256_loadu_si256((const __m256i *)(thrm1 + g * 16));
        __m256i gt = _mm256_cmpgt_epi16(av, tv);      // a > thr-1
        uint32_t mm = (uint32_t)_mm256_movemask_epi8(gt);
        mask |= (uint64_t)_pext_u32(mm, 0xAAAAAAAAu) << (16 * g);
    }
    return mask;
#else
    uint64_t mask = 0;
    for (int i = 1; i < 64; i++) {
        int32_t a = blk[i];
        a = a < 0 ? -a : a;
        mask |= (uint64_t)(a > thrm1[i]) << i;
    }
    return mask;
#endif
}

// Fill thrm1[64] for scale s: thrm1[i] = (d - d/2) - 1 at raw index i.
static void bs_fill_thrm1(int16_t *thrm1, int s) {
    thrm1[0] = 0x7FFF;
    for (int i = 1; i < 64; i++) {
        int32_t d = bs_quant[bs_zagzig[i]] * s;
        thrm1[i] = (int16_t)((d - (d >> 1)) - 1);
    }
}

// Monotone ladder lower bound on a frame's AC bit total at scale s —
// the scalar transcription of ops/bs_pallas.py::ladder_lb (validity,
// safety and monotonicity proofs + pins live there/tests). Early-aborts
// once the running total exceeds thr (only feasibility is consumed).
static bool bs_lb_feasible(const int16_t *czz, long nb, int s, long thr) {
#ifdef BS_DIAG_HOOKS           // eval counters for tools-only harnesses
    g_lb_evals++;
#endif
    int16_t thrm1[64];
    bs_fill_thrm1(thrm1, s);
    // Run-bonus table g(run) (runs are at most 62).
    static const int8_t g_tab[64] = {
        0, 1, 2, 3, 3, 4, 4, 4, 5, 5, 6, 6, 6, 6, 8, 8,
        8, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9,
        9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9,
        9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9};
#ifdef BS_HAVE_AVX2
    // Vector ladder: the per-survivor magnitude classes (6 int16
    // compares) and their weighted sum run over all 64 positions at
    // once; only the run bonuses (sequential gaps between survivors)
    // stay scalar, reading a per-position (c2+c3) byte the vector pass
    // stored. Thresholds above int16 are clamped to 32767: |coef| of a
    // real pixel block is <= 8192 (islow bound), so no reachable value
    // crosses a clamped threshold. Totals match the scalar path
    // exactly.
    alignas(32) int16_t tm1[5][64];
    for (int i = 1; i < 64; i++) {
        int32_t d = bs_quant[bs_zagzig[i]] * s;
        int32_t half = d >> 1;
        const int32_t ks[5] = {2, 3, 4, 5, 7};
        for (int j = 0; j < 5; j++) {
            int32_t t = ks[j] * d - half - 1;      // compare a > t-1
            tm1[j][i] = (int16_t)(t > 32767 ? 32767 : t);
        }
    }
    for (int j = 0; j < 5; j++)
        tm1[j][0] = 32767;                         // DC slot never passes
    // Class weights for the ladder sum: 2*c2 + c3 + 2*c4 + c5 + 2*c7.
    const int16_t w[5] = {2, 1, 2, 1, 2};
    long total = 0;
    alignas(32) int8_t cc[64];
    const __m256i ones16 = _mm256_set1_epi16(1);
    for (long n = 0; n < nb; n++) {
        const int16_t *c = czz + n * 64;
        uint64_t mask = bs_nz_mask64(c, thrm1);
        if (!mask) continue;
        int pop = __builtin_popcountll(mask);
        __m256i acc = _mm256_setzero_si256();
        for (int gq = 0; gq < 4; gq++) {
            __m256i a = _mm256_abs_epi16(_mm256_loadu_si256(
                (const __m256i *)(c + gq * 16)));
            __m256i surv = _mm256_cmpgt_epi16(a, _mm256_loadu_si256(
                (const __m256i *)(thrm1 + gq * 16)));
            __m256i lad = _mm256_setzero_si256();
            __m256i cc16 = _mm256_setzero_si256();
            for (int j = 0; j < 5; j++) {
                __m256i m = _mm256_cmpgt_epi16(a, _mm256_load_si256(
                    (const __m256i *)(tm1[j] + gq * 16)));
                lad = _mm256_add_epi16(
                    lad, _mm256_and_si256(
                        m, _mm256_set1_epi16(w[j])));
                if (j < 2)                         // mask -1 -> +1
                    cc16 = _mm256_sub_epi16(cc16, m);
            }
            lad = _mm256_and_si256(lad, surv);
            acc = _mm256_add_epi32(acc, _mm256_madd_epi16(lad, ones16));
            cc16 = _mm256_and_si256(cc16, surv);
            // Pack (0..2 values, saturation-safe) to bytes in position
            // order: packs interleaves 128-bit lanes, undone by the
            // 0xD8 qword permute.
            __m256i p = _mm256_packs_epi16(cc16, _mm256_setzero_si256());
            p = _mm256_permute4x64_epi64(p, 0xD8);
            _mm_storeu_si128((__m128i *)(cc + gq * 16),
                             _mm256_castsi256_si128(p));
        }
        alignas(32) int32_t lanes[8];
        _mm256_store_si256((__m256i *)lanes, acc);
        long bt = 3L * pop;
        for (int k = 0; k < 8; k++) bt += lanes[k];
        int prev = 0;
        while (mask) {
            int i = __builtin_ctzll(mask);
            mask &= mask - 1;
            int run = i - prev - 1;
            prev = i;
            bt += g_tab[run] + (run >= 1 ? cc[i] : 0);
        }
        total += bt;
        if (total > thr) return false;
    }
    return total <= thr;
#else
    int32_t t2[64], t3[64], t4[64], t5[64], t7[64];
    for (int i = 1; i < 64; i++) {
        int32_t d = bs_quant[bs_zagzig[i]] * s;
        int32_t half = d >> 1;
        t2[i] = 2 * d - half; t3[i] = 3 * d - half;
        t4[i] = 4 * d - half; t5[i] = 5 * d - half; t7[i] = 7 * d - half;
    }
    long total = 0;
    for (long n = 0; n < nb; n++) {
        const int16_t *c = czz + n * 64;
        uint64_t mask = bs_nz_mask64(c, thrm1);
        int prev = 0;
        while (mask) {
            int i = __builtin_ctzll(mask);
            mask &= mask - 1;
            int run = i - prev - 1;
            prev = i;
            int32_t a = c[i];
            a = a < 0 ? -a : a;
            int c2 = a >= t2[i], c3 = a >= t3[i];
            int lb = 3 + 2 * c2 + c3 + 2 * (a >= t4[i]) + (a >= t5[i])
                     + 2 * (a >= t7[i]);
            int g = (run < 3 ? run : 3) + (run >= 5) + (run >= 8)
                    + (run >= 10) + 2 * (run >= 14) + (run >= 17);
            int bonus = (run >= 1 ? c2 + c3 : 0) + g;
            total += lb + bonus;
        }
        if (total > thr) return false;
    }
    return total <= thr;
#endif
}

// Exact AC bit total at scale s, early-aborting once past thr (an
// aborted call's return still proves unfitness; nz is only meaningful
// when the returned total <= thr, i.e. no abort fired).
// Round-up magic reciprocal for quantizer divides: with
// m = floor(2^30/d) + 1, floor(n*m / 2^30) == n/d for all n < 2^16
// provided m*d - 2^30 = d - (2^30 mod d) <= 2^14 (Granlund-Montgomery);
// every reachable d = quant*s <= 83*63 = 5229 <= 2^14 satisfies it, and
// n = |coef| + d/2 <= 32768 + 2614 < 2^16 (coefs are int16). Verified
// exhaustively over the full (d, n) domain at change time; the golden
// and fuzz suites pin it end-to-end.
static inline void bs_fill_minv(uint32_t *minv, int s) {
    for (int i = 1; i < 64; i++)
        minv[i] = (uint32_t)(((1u << 30) /
                              (uint32_t)(bs_quant[bs_zagzig[i]] * s)) + 1);
}

// Exact AC bit total at scale s, early-aborting once past thr. When
// keys/kcnt are non-null and NO abort fires, they receive each block's
// survivor symbol keys (run<<10 | signed-level & 0x3FF, the AC LUT
// index) and per-block counts — the emitter then replays them without
// re-scanning or re-quantizing (an aborted call leaves them partial;
// callers only consume them when the returned total fits).
static long bs_exact_ac_bits_keys(const int16_t *czz, long nb, int s,
                                  long thr, long *nz_out,
                                  uint16_t *keys, uint8_t *kcnt) {
#ifdef BS_DIAG_HOOKS
    g_ex_evals++;
#endif
    int16_t thrm1[64];
    int32_t hv[64];
    uint32_t minv[64];
    bs_fill_thrm1(thrm1, s);
    bs_fill_minv(minv, s);
    for (int i = 1; i < 64; i++)
        hv[i] = (bs_quant[bs_zagzig[i]] * s) >> 1;
    long total = 0, nz = 0;
    for (long n = 0; n < nb; n++) {
        const int16_t *c = czz + n * 64;
        uint64_t mask = bs_nz_mask64(c, thrm1);
        int cnt = __builtin_popcountll(mask);
        nz += cnt;
        uint16_t *kb = keys ? keys + n * 63 : nullptr;
        int k = 0;
        int prev = 0;
        while (mask) {
            int i = __builtin_ctzll(mask);
            mask &= mask - 1;
            int run = i - prev - 1;
            prev = i;
            int32_t v = c[i];
            int32_t a = v < 0 ? -v : v;
            int32_t m = (int32_t)(((uint64_t)(uint32_t)(a + hv[i])
                                   * minv[i]) >> 30);
            // |mag| <= 513 here (|coef| <= 8192 for real pixels, AC
            // quant >= 16), below the negative-key region of the LUT,
            // and bits are sign-symmetric — the UNSIGNED unclamped key
            // is enough for the total (escape levels stay escapes under
            // the clamp, so the bit counts agree); the stored key is
            // the emitter's: signed and wrap+clamped (mdec.c:257-267),
            // which changes the CODE for clamped escape levels.
            total += bs_ac_bits[((uint32_t)run << 10)
                                | ((uint32_t)m & 0x3FF)];
            if (kb) {
                int32_t q = bs_clamp_coeff(v < 0 ? -m : m);
                kb[k++] = (uint16_t)(((uint32_t)run << 10) |
                                     ((uint32_t)q & 0x3FF));
            }
        }
        if (kcnt) kcnt[n] = (uint8_t)cnt;
        if (total > thr) return total;
    }
    *nz_out = nz;
    return total;
}

static inline long bs_exact_ac_bits(const int16_t *czz, long nb, int s,
                                    long thr, long *nz_out) {
    return bs_exact_ac_bits_keys(czz, nb, s, thr, nz_out, nullptr,
                                 nullptr);
}

// MSB-first bitstream chopped into 16-bit words (mdec.c:321-333): a
// 64-bit accumulator takes each symbol in one shift+or (symbols are
// <= 22 bits, so nbits stays < 38) and spills full words from its top.
struct bs_bitpack {
    uint16_t *out;
    long cap, n = 0;
    uint64_t acc = 0;
    int nbits = 0;
    inline void put(uint32_t val, int bits) {
        acc = (acc << bits) | (val & ((1u << bits) - 1u));
        nbits += bits;
        while (nbits >= 16) {
            nbits -= 16;
            if (n < cap) out[n] = (uint16_t)(acc >> nbits);
            n++;
        }
    }
    void flush() {
        if (nbits > 0) {
            uint32_t tail = (uint32_t)(acc & ((1u << nbits) - 1u));
            if (n < cap) out[n] = (uint16_t)(tail << (16 - nbits));
            n++;
            acc = 0;
            nbits = 0;
        }
    }
};

#ifdef BS_HAVE_AVX2
// 8x8 int32 in-register transpose (unpack32 -> unpack64 -> lane swap).
static inline void bs_transpose8_epi32(__m256i v[8]) {
    __m256i a0 = _mm256_unpacklo_epi32(v[0], v[1]);
    __m256i a1 = _mm256_unpackhi_epi32(v[0], v[1]);
    __m256i a2 = _mm256_unpacklo_epi32(v[2], v[3]);
    __m256i a3 = _mm256_unpackhi_epi32(v[2], v[3]);
    __m256i a4 = _mm256_unpacklo_epi32(v[4], v[5]);
    __m256i a5 = _mm256_unpackhi_epi32(v[4], v[5]);
    __m256i a6 = _mm256_unpacklo_epi32(v[6], v[7]);
    __m256i a7 = _mm256_unpackhi_epi32(v[6], v[7]);
    __m256i b0 = _mm256_unpacklo_epi64(a0, a2);
    __m256i b1 = _mm256_unpackhi_epi64(a0, a2);
    __m256i b2 = _mm256_unpacklo_epi64(a1, a3);
    __m256i b3 = _mm256_unpackhi_epi64(a1, a3);
    __m256i b4 = _mm256_unpacklo_epi64(a4, a6);
    __m256i b5 = _mm256_unpackhi_epi64(a4, a6);
    __m256i b6 = _mm256_unpacklo_epi64(a5, a7);
    __m256i b7 = _mm256_unpackhi_epi64(a5, a7);
    v[0] = _mm256_permute2x128_si256(b0, b4, 0x20);
    v[1] = _mm256_permute2x128_si256(b1, b5, 0x20);
    v[2] = _mm256_permute2x128_si256(b2, b6, 0x20);
    v[3] = _mm256_permute2x128_si256(b3, b7, 0x20);
    v[4] = _mm256_permute2x128_si256(b0, b4, 0x31);
    v[5] = _mm256_permute2x128_si256(b1, b5, 0x31);
    v[6] = _mm256_permute2x128_si256(b2, b6, 0x31);
    v[7] = _mm256_permute2x128_si256(b3, b7, 0x31);
}

// Truncate (wrap, NOT saturate — matches the scalar (int16_t) cast) 8
// int32 lanes to 8 int16 and return them in the low 128 bits.
static inline __m128i bs_trunc16_epi32(__m256i v) {
    const __m256i pick = _mm256_setr_epi8(
        0, 1, 4, 5, 8, 9, 12, 13, -1, -1, -1, -1, -1, -1, -1, -1,
        0, 1, 4, 5, 8, 9, 12, 13, -1, -1, -1, -1, -1, -1, -1, -1);
    __m256i t = _mm256_shuffle_epi8(v, pick);
    t = _mm256_permute4x64_epi64(t, 0x08);   // lanes {0, 2} -> low 128
    return _mm256_castsi256_si128(t);
}
#endif

// Rearrange + FDCT + zigzag store for one frame's nb blocks (once per
// frame; the reference re-runs this per scale retry, mdec.c:640-643).
// Blocks run 8 at a time through the SoA FDCT (lanes = blocks); the
// tail takes the scalar path. Encode order n = (mx*mb_y + my)*6 + p.
// With AVX2 the gather and the zigzag store run as 8x8 register
// transposes (row loads / truncating int16 stores) instead of scalar
// element loops — identical values, ~2x the stage.
static void bs_frame_coefs(const uint8_t *frame, int width, int height,
                           int16_t *czz) {
    const int mb_x = width / 16, mb_y = height / 16;
    const long nb = (long)mb_x * mb_y * 6;
    const uint8_t *yp = frame;
    const uint8_t *cp = frame + (long)width * height;  // interleaved Cr/Cb
    const int cw = width / 2;

    auto gather = [&](long n, int32_t *d, int lane, int stride) {
        int p = (int)(n % 6);
        long m = n / 6;
        int my = (int)(m % mb_y), mx = (int)(m / mb_y);
        if (p < 2) {                               // Cr then Cb
            for (int r = 0; r < 8; r++)
                for (int c = 0; c < 8; c++)
                    d[(8 * r + c) * stride + lane] =
                        (int32_t)cp[((my * 8 + r) * cw +
                                     (mx * 8 + c)) * 2 + p] - 128;
        } else {                                   // Y quadrants
            int a = (p - 2) >> 1, b = (p - 2) & 1;
            const uint8_t *yb = yp + (long)(my * 16 + a * 8) * width +
                                mx * 16 + b * 8;
            for (int r = 0; r < 8; r++)
                for (int c = 0; c < 8; c++)
                    d[(8 * r + c) * stride + lane] =
                        (int32_t)yb[(long)r * width + c] - 128;
        }
    };
    long n = 0;
    alignas(32) bs_vrow soa[64];
#ifdef BS_HAVE_AVX2
    const __m256i c128 = _mm256_set1_epi32(128);
    // Chroma rows interleave Cr/Cb; loads always start at the EVEN (Cr)
    // byte so the 16-byte read never crosses the plane end (a Cb-based
    // load would overread 1 byte on the frame's last chroma row).
    const __m128i evens = _mm_setr_epi8(
        0, 2, 4, 6, 8, 10, 12, 14, -1, -1, -1, -1, -1, -1, -1, -1);
    const __m128i odds = _mm_setr_epi8(
        1, 3, 5, 7, 9, 11, 13, 15, -1, -1, -1, -1, -1, -1, -1, -1);
    for (; n + BS_SOA <= nb; n += BS_SOA) {
        // Gather: per sample row r, load each block's 8 samples as one
        // int32x8 vector (Y rows are contiguous bytes; chroma rows are
        // stride-2 bytes compacted by a shuffle), then one transpose
        // scatters them to the SoA rows 8r..8r+7 (lanes = blocks).
        const uint8_t *base[BS_SOA];
        long strd[BS_SOA];
        int kind[BS_SOA];                        // 0=Y 1=Cr 2=Cb
        for (int b = 0; b < BS_SOA; b++) {
            long q = n + b;
            int p = (int)(q % 6);
            long m = q / 6;
            int my = (int)(m % mb_y), mx = (int)(m / mb_y);
            if (p < 2) {
                base[b] = cp + ((long)(my * 8) * cw + mx * 8) * 2;
                strd[b] = (long)cw * 2;
                kind[b] = 1 + p;
            } else {
                int a = (p - 2) >> 1, bq = (p - 2) & 1;
                base[b] = yp + (long)(my * 16 + a * 8) * width +
                          mx * 16 + bq * 8;
                strd[b] = width;
                kind[b] = 0;
            }
        }
        for (int r = 0; r < 8; r++) {
            __m256i v[8];
            for (int b = 0; b < BS_SOA; b++) {
                const uint8_t *pr = base[b] + r * strd[b];
                __m128i bytes;
                if (kind[b] == 0) {            // Y row: contiguous
                    bytes = _mm_loadl_epi64((const __m128i *)pr);
                } else {                       // chroma row: stride 2
                    __m128i raw =
                        _mm_loadu_si128((const __m128i *)pr);
                    bytes = _mm_shuffle_epi8(
                        raw, kind[b] == 1 ? evens : odds);
                }
                v[b] = _mm256_sub_epi32(_mm256_cvtepu8_epi32(bytes),
                                        c128);
            }
            bs_transpose8_epi32(v);
            for (int c = 0; c < 8; c++)
                _mm256_store_si256((__m256i *)soa[8 * r + c], v[c]);
        }
        bs_fdct_soa8(soa);
        // Zigzag + int16 store: per group of 8 zigzag positions, load
        // the 8 source SoA rows, transpose (lanes -> blocks), truncate
        // to int16 and store each block's 8 coefficients contiguously.
        for (int g = 0; g < 8; g++) {
            __m256i v[8];
            for (int j = 0; j < 8; j++)
                v[j] = _mm256_load_si256(
                    (const __m256i *)soa[bs_zagzig[8 * g + j]]);
            bs_transpose8_epi32(v);
            for (int b = 0; b < BS_SOA; b++)
                _mm_storeu_si128(
                    (__m128i *)(czz + (n + b) * 64 + 8 * g),
                    bs_trunc16_epi32(v[b]));
        }
    }
#else
    for (; n + BS_SOA <= nb; n += BS_SOA) {
        for (int b = 0; b < BS_SOA; b++)
            gather(n + b, &soa[0][0], b, BS_SOA);
        bs_fdct_soa8(soa);
        for (int b = 0; b < BS_SOA; b++) {
            int16_t *dst = czz + (n + b) * 64;
            for (int pos = 0; pos < 64; pos++)
                dst[pos] = (int16_t)soa[bs_zagzig[pos]][b];
        }
    }
#endif
    // Tail (nb % 8 blocks; nb = mb_x*mb_y*6 is bounded by the frame
    // geometry — the long count is only for pointer math). The trip
    // bound is stated to the compiler: the main loop above ran while
    // n + BS_SOA <= nb, so fewer than BS_SOA blocks remain.
    if (nb - n >= BS_SOA) __builtin_unreachable();
    for (long rem = nb - n; rem > 0; rem--, n++) {
        int32_t d[64];
        gather(n, d, 0, 1);
        bs_fdct_block(d);
        int16_t *dst = czz + n * 64;
        for (int pos = 0; pos < 64; pos++)
            dst[pos] = (int16_t)d[bs_zagzig[pos]];
    }
}

// Emission at the winning scale + 16-bit MSB-first packing: replays the
// symbol keys the winning exact eval cached — no second scan, no second
// quantization (the reference re-quantizes per emission, mdec.c:640).
static void bs_frame_emit(const uint16_t *keys, const uint8_t *kcnt,
                          long nb, int codec, const uint8_t *dcb,
                          const uint32_t *dcc, uint16_t *words,
                          long cap_words) {
    bs_bitpack bp{words, cap_words};
    for (long n = 0; n < nb; n++) {
        bp.put(dcc[n], dcb[n]);
        const uint16_t *kb = keys + n * 63;
        int cnt = kcnt[n];
        for (int k = 0; k < cnt; k++) {
            uint32_t key = kb[k];
            bp.put(bs_ac_code[key], bs_ac_bits[key]);
        }
        bp.put(0x2, 2);                            // end-of-block
    }
    bp.put(codec == 0 ? 0x1FF : 0x3FF, 10);        // end-of-frame
    bp.flush();
}

// Cross-frame select seeds (0 = cold): the previous answer scale and
// the previous exact-walk start (end of the LB-proven-unfit prefix + 1).
struct bs_seed {
    int scale = 0;
    int slb = 0;
};

// Scratch for one worker's frame encodes: symbol-key caches for the
// speculative eval and the walk (two, so a later aborted walk eval
// cannot corrupt the cached speculative symbols).
struct bs_scratch {
    std::vector<uint16_t> keys_sl, keys_wk;       // (nb, 63) each
    std::vector<uint8_t> kcnt_sl, kcnt_wk;        // (nb,) each
    void reserve(long nb) {
        keys_sl.resize(nb * 63);
        keys_wk.resize(nb * 63);
        kcnt_sl.resize(nb);
        kcnt_wk.resize(nb);
    }
};

static void bs_encode_one_frame(const uint8_t *frame, int width, int height,
                                int codec, long budget, long cap_words,
                                uint16_t *words, int32_t *scale_out,
                                int32_t *total_out, int32_t *nz_out,
                                int16_t *czz, uint8_t *dcb, uint32_t *dcc,
                                bs_seed *seed_io, bs_scratch *scr) {
    const long nb = (long)(width / 16) * (height / 16) * 6;
    bs_frame_coefs(frame, width, height, czz);

    // --- scale-independent DC stage (quant by 8*quant[0] = 16,
    // mdec.c:671; v3/v3dc delta chains per block type, mdec.c:455-480).
    long dc_total = 0;
    if (codec == 0) {                              // BS v2
        for (long i = 0; i < nb; i++) {
            int32_t dq = bs_clamp_coeff(bs_div_rounded(czz[i * 64], 16));
            dcb[i] = 10;
            dcc[i] = (uint32_t)dq & 0x3FF;
        }
        dc_total = 10 * nb;
    } else {
        int32_t last[3] = {0, 0, 0};
        for (long i = 0; i < nb; i++) {
            int t = (int)(i % 6);
            if (t > 2) t = 2;
            int32_t dq = bs_clamp_coeff(bs_div_rounded(czz[i * 64], 16));
            int32_t delta = bs_div_rounded(dq - last[t], 4);
            last[t] += 4 * delta;
            int32_t kd = delta;
            if (codec == 2) {                      // BS v3dc wrap
                if (kd < -0x80) kd += 0x100;
                if (kd > 0x80) kd -= 0x100;
            }
            uint32_t key = (uint32_t)kd & 0x1FF;
            int tree = t == 2 ? 1 : 0;
            dcb[i] = bs_dc_bits[tree][key];
            dcc[i] = bs_dc_code[tree][key];
            dc_total += dcb[i];
        }
    }

    // --- first-fit scale: a frame fits iff ac_bits <= thr (the exact
    // inverse of 8 + 2*ceil(total_bits/16) <= budget, mdec.c:321-333).
    long hw = budget - 8;
    long cwords = hw >= 0 ? hw / 2 : -((-hw + 1) / 2);  // floor division
    long thr = 16 * cwords - (dc_total + 2 * nb + 10);

    // Seeded first-fit select, mirroring the Mosaic select kernel
    // (ops/bs_pallas.py::_search_store): the answer is the SMALLEST
    // scale whose exact AC total fits, so every scale below it needs an
    // unfitness proof — either one monotone-LB eval covering a whole
    // prefix [1, lo], or a per-scale early-aborting exact eval. Two
    // seeds carry across frames (consecutive frames look alike):
    // seed->scale speculates the answer (its exact eval is cached for
    // the walk) and seed->slb speculates the LB-prefix end, so steady
    // content pays 1 LB + (LB-to-exact gap) exact evals per frame —
    // the old single-seed form re-bisected the LB boundary from
    // scratch whenever the gap was nonzero (~7 extra LB evals per
    // frame on knife-edge content).
    int scale = 64;
    long ac_bits = 0, nz = 0;
    const uint16_t *emit_keys = nullptr;
    const uint8_t *emit_kcnt = nullptr;
    if (thr >= 0) {
        int sl = (seed_io->scale >= 1 && seed_io->scale <= 63)
                     ? seed_io->scale : 32;
        // Speculative exact eval at the previous answer (early-abort);
        // the walk reuses it when it reaches sl. Its symbol keys are
        // cached in their own buffer so failing walk evals can't
        // clobber them before the walk reaches sl.
        long nz_sl = 0;
        long b_sl = bs_exact_ac_bits_keys(czz, nb, sl, thr, &nz_sl,
                                          scr->keys_sl.data(),
                                          scr->kcnt_sl.data());
        bool efit = b_sl <= thr;

        // Establish lo with LB(lo) infeasible ([1, lo] proven unfit by
        // monotonicity; lo = 0 is the empty proof). Probe the seeded
        // boundary first; a feasible probe means the boundary moved
        // down — gallop toward 1, then bisect the bracket closed (each
        // LB eval here saves several exact evals in the walk).
        int sb = (seed_io->slb >= 1 && seed_io->slb <= 63)
                     ? seed_io->slb : sl;
        if (efit && sb > sl) sb = sl;   // never start the walk past a
                                        // fitting speculative answer
        int lo = 0, hi = 64, step = 1;
        int probe = sb - 1;
        while (probe >= 1) {
            if (!bs_lb_feasible(czz, nb, probe, thr)) {
                lo = probe;
                break;
            }
            hi = probe;
            probe = hi - step;
            step *= 2;
        }
        while (hi - lo > 1 && hi < 64) {
            int mid = (lo + hi) >> 1;
            if (bs_lb_feasible(czz, nb, mid, thr)) hi = mid;
            else lo = mid;
        }
        // When hi < 64 the bisect closed the bracket (lo == hi - 1), so
        // the walk starts at the exact LB boundary.

        // Next frame's boundary seed: the first LB-feasible scale when
        // the bracket closed, else the (sticky) walk start. An upward
        // escalation in the walk below overwrites it with its own
        // bracket's first LB-feasible scale — a HINT for the next
        // frame's probe, possibly above that frame's true boundary
        // (seeds steer eval order only, never proofs).
        int slb = (hi < 64) ? hi : lo + 1;
        seed_io->slb = slb <= 63 ? slb : 63;

        // Exact first-fit walk from lo+1. Scales between the LB
        // boundary and the answer are LB-feasible, so only exact evals
        // can prove them unfit — LB evals there are pure waste; but
        // once the walk passes the speculative answer (upward content
        // drift), the boundary has likely moved too, and a lazy LB
        // gallop+bisect bulk-proves the drift region instead of paying
        // one exact eval per scale.
        int s = lo + 1, miss = 0;
        while (s <= 63) {
            long nz_s = 0;
            long b;
            bool cached = (s == sl);
            if (cached) {
                b = b_sl;
                nz_s = nz_sl;
            } else {
                b = bs_exact_ac_bits_keys(czz, nb, s, thr, &nz_s,
                                          scr->keys_wk.data(),
                                          scr->kcnt_wk.data());
                if (s > sl) miss++;
            }
            if (b <= thr) {                        // no abort: nz exact
                scale = s;
                ac_bits = b;
                nz = nz_s;
                emit_keys = cached ? scr->keys_sl.data()
                                   : scr->keys_wk.data();
                emit_kcnt = cached ? scr->kcnt_sl.data()
                                   : scr->kcnt_wk.data();
                break;
            }
            if (miss >= 4 && s < 62) {
                int glo = s, ghi = 64, gstep = 2;
                while (ghi == 64 && glo + gstep <= 63) {
                    int gp = glo + gstep;
                    if (bs_lb_feasible(czz, nb, gp, thr)) ghi = gp;
                    else glo = gp;
                    gstep *= 2;
                }
                while (ghi - glo > 1) {
                    int mid = (glo + ghi) >> 1;
                    if (bs_lb_feasible(czz, nb, mid, thr)) ghi = mid;
                    else glo = mid;
                }
                s = glo + 1;
                seed_io->slb = ghi <= 63 ? ghi : 63;
                miss = 0;
                continue;
            }
            s++;
        }
    }
    // An unfittable frame seeds the next at 63 (64 is unprobeable and
    // would cold-walk every following frame — the kernel's gotcha).
    seed_io->scale = scale <= 63 ? scale : 63;
    *scale_out = scale;
    if (scale >= 64) {                             // caller raises
        *total_out = 0;
        *nz_out = 0;
        return;
    }
    *total_out = (int32_t)(ac_bits + dc_total + 2 * nb + 10);
    *nz_out = (int32_t)nz;
    bs_frame_emit(emit_keys, emit_kcnt, nb, codec, dcb, dcc, words,
                  cap_words);
}

// Encode B NV21 frames with per-frame byte budgets into packed 16-bit
// bitstream words — outputs mirror api.bs_encode_frames_packed: words
// (B, capacity_words) u16, scale/total_bits/nz_count (B,) i32 (scale 64
// = unfittable, caller errors like mdec.c:723). codec: 0=v2 1=v3 2=v3dc.
// Frames are independent (the v3 DC chain is per-frame), so they fan
// out over n_threads host threads.
void psxn_bs_encode_frames(const uint8_t *frames, const int32_t *budgets,
                           long B, int width, int height, int codec,
                           long capacity_words, int n_threads,
                           uint16_t *words_out, int32_t *scale_out,
                           int32_t *total_bits_out, int32_t *nz_out,
                           int32_t *seeds_io) {
    std::call_once(bs_luts_once, bs_luts_init);
    const long fbytes = (long)width * height * 3 / 2;
    const long nb = (long)(width / 16) * (height / 16) * 6;

    auto worker = [&](long t, long nt) {
        std::vector<int16_t> czz(nb * 64);
        std::vector<uint8_t> dcb(nb);
        std::vector<uint32_t> dcc(nb);
        bs_scratch scr;
        scr.reserve(nb);
        // Per-worker seeds (its stride stays temporally close); callers
        // may pass an (n_threads, 2) int32 array to carry them across
        // calls — chunked encoders then start every chunk warm. Seeds
        // only steer eval order, never the selected scale.
        bs_seed seed;
        if (seeds_io) {
            seed.scale = seeds_io[2 * t];
            seed.slb = seeds_io[2 * t + 1];
        }
        for (long i = t; i < B; i += nt)
            bs_encode_one_frame(
                frames + i * fbytes, width, height, codec, budgets[i],
                capacity_words, words_out + i * capacity_words,
                scale_out + i, total_bits_out + i, nz_out + i,
                czz.data(), dcb.data(), dcc.data(), &seed, &scr);
        if (seeds_io) {
            seeds_io[2 * t] = seed.scale;
            seeds_io[2 * t + 1] = seed.slb;
        }
    };
    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > B) nt = B;
    if (nt <= 1) {
        worker(0, 1);
    } else {
        std::vector<std::thread> threads;
        for (long t = 0; t < nt; t++)
            threads.emplace_back(worker, t, nt);
        for (auto &th : threads) th.join();
    }
}

}  // extern "C"
