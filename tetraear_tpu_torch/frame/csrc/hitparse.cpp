// Native batch engine for the per-hit host frame layer.
//
// One call parses a batch of 510-bit candidate frame windows (the
// device scan's sync hits) through the STATELESS part of the host
// frame path: burst typing, frame-stealing detection, the reference's
// lenient soft CRC-16 gate, and downlink MAC PDU field extraction.
// Bit-for-bit equivalent of the Python oracles it accelerates:
//   burst typing / stolen:  tetraear_tpu_torch/frame/burst.py
//     (detect_burst_type, sync_agreement; reference
//      tetraear/core/protocol.py:246-265, 162-163)
//   soft CRC:               tetraear_tpu_torch/frame/crc.py soft_crc_check
//     (reference protocol.py:292-347: <=2 bit errors, reversed-payload
//      fallback, degenerate all-0/all-1 rejection)
//   MAC fields:             tetraear_tpu_torch/frame/mac.py
//     extract_mac_fields (reference protocol.py:349-596)
// Equivalence is pinned by tests/unit/test_hitparse.py against those
// oracles on golden and random windows.
//
// The stateful remainder (fragment reassembly, SYSINFO network
// identity, stats, frame dicts, SDS) stays in Python
// (MacParser.apply_mac_fields), consuming these pre-extracted fields.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kFrameBits = 510;
constexpr int kDataMaxBytes = 64;   // ceil((510 - 4) / 8) = 64

// 22-bit downlink sync trainings (frame/burst.py:26-31)
const uint8_t kSyncC[22] = {1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1,
                            0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0};
const uint8_t kSyncD[22] = {0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0,
                            0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0};

inline int agreement22(const uint8_t* w, const uint8_t* pat) {
  int m = 0;
  for (int i = 0; i < 22; ++i) m += ((w[i] & 1) == pat[i]);
  return m;
}

// CRC-16-CCITT, poly 0x1021, init 0xFFFF, bit-at-a-time MSB first
// (frame/crc.py crc16_bits).
uint16_t crc16_bits(const uint8_t* bits, int n) {
  uint32_t crc = 0xFFFF;
  for (int i = 0; i < n; ++i) {
    crc ^= static_cast<uint32_t>(bits[i] & 1) << 15;
    crc = (crc & 0x8000) ? ((crc << 1) ^ 0x1021) & 0xFFFF
                         : (crc << 1) & 0xFFFF;
  }
  return static_cast<uint16_t>(crc);
}

// frame/crc.py soft_crc_check (max_errors = 2).
int soft_crc_ok(const uint8_t* data, int n) {
  if (n < 16) return 0;
  int ones = 0;
  for (int i = 0; i < n; ++i) ones += data[i] & 1;
  if (ones == 0 || ones == n) return 0;
  const int pl = n - 16;
  uint16_t rec = 0;
  for (int i = 0; i < 16; ++i) rec = (rec << 1) | (data[pl + i] & 1);
  if (__builtin_popcount(static_cast<unsigned>(crc16_bits(data, pl) ^ rec))
      <= 2)
    return 1;
  uint8_t rev[kFrameBits];
  for (int i = 0; i < pl; ++i) rev[i] = data[pl - 1 - i] & 1;
  return __builtin_popcount(
             static_cast<unsigned>(crc16_bits(rev, pl) ^ rec)) <= 2;
}

// frame/burst.py bits_to_uint (MSB first).
inline uint64_t bits_to_uint(const uint8_t* b, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 1) | (b[i] & 1);
  return v;
}

// frame/burst.py bits_to_bytes (MSB first, zero-padded tail).
inline int bits_to_bytes(const uint8_t* b, int n, uint8_t* out) {
  const int nb = (n + 7) / 8;
  for (int i = 0; i < nb; ++i) {
    uint8_t v = 0;
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * i + j;
      v = static_cast<uint8_t>((v << 1) | (k < n ? (b[k] & 1) : 0));
    }
    out[i] = v;
  }
  return nb;
}

}  // namespace

extern "C" {

// Parse n windows of 510 bits each (values 0/1, row-major).
// Outputs (all length n unless noted):
//   is_sync      burst type: 1 = Synchronization, 0 = NormalDownlink
//   stolen       NTS2 frame-stealing verdict (m2 > m1 at bit 216)
//   crc_ok       soft CRC verdict of the burst data bits
//   mac_valid    0 where extract_mac_fields would return None
//   pdu_type     MAC PDU type bits (0..3)
//   enc_mode     encryption-mode bits (0..3)
//   fill_bit     fill bit (0 for BROADCAST)
//   address      24-bit address for MAC-RESOURCE, else -1
//   length       6-bit length field (RESOURCE / END), else 0
//   has_sysinfo  1 when a valid SYSINFO broadcast (mcc/mnc/cc set)
//   mcc/mnc/cc   SYSINFO fields (-1 when has_sysinfo == 0)
//   data_len     MAC data bytes per window
//   data         (n, 64) MAC data bytes
// Returns 0 on success.
int hitparse_batch(const uint8_t* wins, int64_t n, uint8_t* is_sync,
                   uint8_t* stolen, uint8_t* crc_ok, uint8_t* mac_valid,
                   uint8_t* pdu_type, uint8_t* enc_mode, uint8_t* fill_bit,
                   int64_t* address, int32_t* length, uint8_t* has_sysinfo,
                   int32_t* mcc, int32_t* mnc, int32_t* cc,
                   int32_t* data_len, uint8_t* data) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* w = wins + i * kFrameBits;
    uint8_t* dout = data + i * kDataMaxBytes;
    std::memset(dout, 0, kDataMaxBytes);

    // burst typing: sync word at the slot midpoint (> 0.8 * 22 agreement)
    const int mc = agreement22(w + kFrameBits / 2, kSyncC);
    const int md = agreement22(w + kFrameBits / 2, kSyncD);
    const bool sync = (mc > md ? mc : md) >= 18;
    is_sync[i] = sync;

    // frame stealing: NTS1 vs NTS2 agreement at the training position
    const int m1 = agreement22(w + 216, kSyncC);
    const int m2 = agreement22(w + 216, kSyncD);
    stolen[i] = m2 > m1;

    // burst data bits (frame/burst.py extract_data_bits)
    uint8_t db[kFrameBits];
    int dn;
    if (!sync) {
      std::memcpy(db, w, 108);
      std::memcpy(db + 108, w + 122, 108);
      dn = 216;
    } else {
      std::memcpy(db, w, kFrameBits);
      dn = kFrameBits;
    }
    crc_ok[i] = static_cast<uint8_t>(soft_crc_ok(db, dn));

    // MAC field extraction (frame/mac.py extract_mac_fields)
    mac_valid[i] = 0;
    pdu_type[i] = enc_mode[i] = fill_bit[i] = 0;
    address[i] = -1;
    length[i] = 0;
    has_sysinfo[i] = 0;
    mcc[i] = mnc[i] = cc[i] = -1;
    data_len[i] = 0;
    if (dn < 8) continue;
    const int pt = ((db[0] & 1) << 1) | (db[1] & 1);
    const int em = ((db[2] & 1) << 1) | (db[3] & 1);
    pdu_type[i] = static_cast<uint8_t>(pt);
    enc_mode[i] = static_cast<uint8_t>(em);

    if (pt == 0) {  // MAC-RESOURCE
      fill_bit[i] = db[4] & 1;
      int pos = 5;
      if (dn < pos + 24) continue;
      address[i] = static_cast<int64_t>(bits_to_uint(db + pos, 24));
      pos += 24;
      if (dn < pos + 6) continue;
      const int len = static_cast<int>(bits_to_uint(db + pos, 6));
      length[i] = len;
      pos += 6;
      const int dlb = len * 8;
      if (dlb > dn - pos + 16) continue;
      const int take = (0 < dlb && dlb <= dn - pos) ? dlb : dn - pos;
      data_len[i] = bits_to_bytes(db + pos, take, dout);
    } else if (pt == 1) {  // MAC-FRAG
      fill_bit[i] = db[4] & 1;
      data_len[i] = bits_to_bytes(db + 5, dn - 5, dout);
    } else if (pt == 2) {  // MAC-BROADCAST
      const int pos = 4;
      if (em == 0) {  // SYSINFO: MCC(10) MNC(14) CC(6) + E.212 gate
        if (dn < pos + 30) continue;
        const int mv = static_cast<int>(bits_to_uint(db + pos, 10));
        const int nv = static_cast<int>(bits_to_uint(db + pos + 10, 14));
        const int cv = static_cast<int>(bits_to_uint(db + pos + 24, 6));
        if (mv < 200 || mv > 799) continue;
        if (nv > 999) continue;
        has_sysinfo[i] = 1;
        mcc[i] = mv;
        mnc[i] = nv;
        cc[i] = cv;
      }
      data_len[i] = bits_to_bytes(db + pos, dn - pos, dout);
    } else {  // MAC-END / fallback
      fill_bit[i] = db[4] & 1;
      int pos = 5;
      if (dn < pos + 6) continue;
      const int len = static_cast<int>(bits_to_uint(db + pos, 6));
      length[i] = len;
      pos += 6;
      const int dlb = len * 8;
      if (dlb > dn - pos + 16) continue;
      const int take = (0 < dlb && dlb <= dn - pos) ? dlb : dn - pos;
      data_len[i] = bits_to_bytes(db + pos, take, dout);
    }
    mac_valid[i] = 1;
  }
  return 0;
}

}  // extern "C"
