// Host sector code of psxavenc_tpu_torch: CD-ROM EDC checksums and sector
// framing (behavior of libpsxav/cdrom.c) and XA sector assembly from the
// ADPCM headers and sample values the unit encoder computed (layout of
// libpsxav/adpcm.c:193-332). Byte-level work on one sector at a time; it
// stays on the host, as it does in psxavenc_tpu (psxav_native.cpp).
//
// Exposed as a plain C ABI loaded with ctypes (native/host.py).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- EDC CRC32

// Reflected CRC-32 with polynomial 0xD8018001, LSB-first, zero init and no
// final xor (cdrom.c:30-41), table-driven per byte.
static uint32_t edc_table[256];
static bool edc_ready = false;

static void edc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t v = i;
        for (int j = 0; j < 8; j++)
            v = (v >> 1) ^ (0xD8018001u * (v & 1));
        edc_table[i] = v;
    }
    edc_ready = true;
}

uint32_t psxh_edc(const uint8_t *data, long length) {
    if (!edc_ready) edc_init();
    uint32_t edc = 0;
    for (long i = 0; i < length; i++)
        edc = (edc >> 8) ^ edc_table[(edc ^ data[i]) & 0xFF];
    return edc;
}

// Compute and store EDC for a batch of equally-framed sectors laid out
// contiguously: for each sector, CRC bytes [crc_off, crc_off+crc_len) and
// store LE32 at edc_off.
void psxh_edc_batch(uint8_t *base, long nsectors, long stride,
                    long crc_off, long crc_len, long edc_off) {
    for (long s = 0; s < nsectors; s++) {
        uint8_t *sec = base + s * stride;
        uint32_t edc = psxh_edc(sec + crc_off, crc_len);
        sec[edc_off + 0] = (uint8_t)edc;
        sec[edc_off + 1] = (uint8_t)(edc >> 8);
        sec[edc_off + 2] = (uint8_t)(edc >> 16);
        sec[edc_off + 3] = (uint8_t)(edc >> 24);
    }
}

// ------------------------------------------------------------ sector framing

// type: 0 = Mode1, 1 = Mode2 Form1, 2 = Mode2 Form2 (cdrom.c:45-74).
void psxh_sector_init(uint8_t *sector, int lba, int type) {
    memset(sector, 0xFF, 12);
    sector[0x0] = 0x00;
    sector[0xB] = 0x00;
    lba += 150;
    int m = lba / 4500, s = (lba / 75) % 60, f = lba % 75;
    sector[12] = (uint8_t)(m + (m / 10) * 6);
    sector[13] = (uint8_t)(s + (s / 10) * 6);
    sector[14] = (uint8_t)(f + (f / 10) * 6);
    if (type == 0) {
        sector[15] = 0x01;
    } else {
        sector[15] = 0x02;
        memset(sector + 16, 0, 8);
        uint8_t submode = 0x08;            // DATA
        if (type == 2) submode |= 0x20;    // FORM2
        sector[16 + 2] = submode;
        sector[16 + 4 + 2] = submode;
    }
}

// Checksums exactly as cdrom.c:76-110 (ECC intentionally left zeroed, as in
// the reference; authoring tools regenerate it).
void psxh_calc_checksums(uint8_t *sector, int type) {
    uint32_t edc;
    switch (type) {
    case 0:
        edc = psxh_edc(sector, 0x810);
        sector[0x810] = (uint8_t)edc;
        sector[0x811] = (uint8_t)(edc >> 8);
        sector[0x812] = (uint8_t)(edc >> 16);
        sector[0x813] = (uint8_t)(edc >> 24);
        memset(sector + 0x814, 0, 8);
        break;
    case 1:
        edc = psxh_edc(sector + 0x10, 0x808);
        sector[0x818] = (uint8_t)edc;
        sector[0x819] = (uint8_t)(edc >> 8);
        sector[0x81A] = (uint8_t)(edc >> 16);
        sector[0x81B] = (uint8_t)(edc >> 24);
        break;
    case 2:
        edc = psxh_edc(sector + 0x10, 0x91C);
        sector[0x92C] = (uint8_t)edc;
        sector[0x92D] = (uint8_t)(edc >> 8);
        sector[0x92E] = (uint8_t)(edc >> 16);
        sector[0x92F] = (uint8_t)(edc >> 24);
        break;
    }
}

// --------------------------------------------------------- XA block assembly

// Assemble the 2304-byte ADPCM payload of one XA sector from 18 blocks of
// unit headers and sample values.
//
// headers:  (18, units_per_block) bytes, in encode order.
// nibbles:  (18, units_per_block, 28) bytes.
// Layouts per adpcm.c:193-233; header bytes at data offsets
// {0,1,2,3,8,9,10,11} then duplicated to {4..7, 12..15} (adpcm.c:321-322).
void psxh_xa_assemble(uint8_t *payload2304, const uint8_t *headers,
                      const uint8_t *nibbles, int units_per_block,
                      int bits8) {
    static const int hdr_pos[8] = {0, 1, 2, 3, 8, 9, 10, 11};
    for (int b = 0; b < 18; b++) {
        uint8_t *blk = payload2304 + b * 128;
        const uint8_t *h = headers + b * units_per_block;
        const uint8_t *nb = nibbles + b * units_per_block * 28;
        memset(blk, 0, 128);
        for (int u = 0; u < units_per_block; u++)
            blk[hdr_pos[u]] = h[u];
        if (!bits8) {
            for (int u = 0; u < units_per_block; u++) {
                int off = 0x10 + (u >> 1);
                int shift = (u & 1) ? 4 : 0;
                for (int i = 0; i < 28; i++)
                    blk[off + 4 * i] |= (uint8_t)(nb[u * 28 + i] << shift);
            }
        } else {
            for (int u = 0; u < units_per_block; u++) {
                int off = 0x10 + u;
                for (int i = 0; i < 28; i++)
                    blk[off + 4 * i] = nb[u * 28 + i];
            }
        }
        memcpy(blk + 4, blk, 4);
        memcpy(blk + 12, blk + 8, 4);
    }
}

}  // extern "C"
