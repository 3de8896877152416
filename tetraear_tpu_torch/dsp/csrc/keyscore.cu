// key_score: the deferred key search's plaintext scores, a record a row.
//
// TetraDecoder._score_decrypt of every row, and what it does to the
// scoring decoder's parser (frame/decoder.py score_plaintext and
// apply_score_effects), written as crypto/keyscore.py's records:
//
//   out[0][r]  the score (without its SDS term where FLAG is set);
//   out[1][r]  FLAG (the SDS term left to the host: the GSM-7 user type
//              07 00, and the heuristic text fallback on a payload that
//              Python's utf-8 decoder reads with a character past
//              ASCII), COUNT (parse_sds_data counts a data message),
//              MAC_OK | type << 3 | mode << 5 (extract_mac_fields finds
//              fields), SYSINFO (they carry a network identity);
//   out[2][r]  that identity: mcc | mnc << 10 | colour code << 24.
//
// Rows: the K x B plaintexts of a tea_search decrypt launch (row k B + b),
// then the B payloads themselves (row K B + b, read from the payload
// words).  Row b's length is lengths[b]; from there on its bytes read 0,
// as the host's truncated plaintext has none.  It replaces no TPU
// kernel: the reference scores these plaintexts on the host.
//
// Bound: the bytes, L read and 12 written a row; the walks over a row (a
// byte pass, the SDS text gates, two CRC-16 passes, two GSM7 unpackings)
// run one after another in its thread.  Design: a thread a row (rows are
// independent and short); the row's bytes are read through L1, which
// holds them across the walks; crypto/keyscore.py's SCORE_TABLE (the
// character classes of frame/sds.py's text gates, built from Python's
// own predicates) and a byte-wise CRC table sit in shared memory.  Ratios
// are float64 divisions compared as Python compares them (the file is
// built with -fmad=false).
#include "common.cuh"

namespace {

constexpr int kCta = 128;
// SCORE_TABLE: [0, 256) the GSM7 characters, [256, 512) latin-1 bytes,
// [512, 768) cp1252 bytes
constexpr int kLatin1 = 256, kCp1252 = 512, kTable = 768;
enum : int {
  kPresent = 1, kSpace = 2, kAlpha = 4, kPrintS = 8, kAlnumS = 16,
  kPrintV = 32, kAlnumV = 64, kAscii = 128
};
enum : int { kLPrint = 1, kLAlnum = 2, kLBlank = 4, kLUndefined = 8 };
enum : int { kFlag = 1, kCount = 2, kMacOk = 4, kSysinfo = 128 };

struct Row {
  const uint8_t* p;          // a plaintext row, or null for a payload row
  const uint32_t* w0;        // the payload's words (big-endian)
  const uint32_t* w1;
  int n;                     // bytes in the row
  __device__ __forceinline__ uint32_t operator[](int i) const {
    if (i < 0 || i >= n) return 0u;
    if (p) return __ldg(p + i);
    const uint32_t w = __ldg(((i & 4) ? w1 : w0) + (i >> 3));
    return (w >> (24 - 8 * (i & 3))) & 0xFFu;
  }
};

// Bits [pos, pos + width) of the row, MSB first, width <= 24.
__device__ __forceinline__ uint32_t row_bits(const Row& r, int pos,
                                             int width) {
  const int b = pos >> 3;
  const uint32_t x = (r[b] << 24) | (r[b + 1] << 16) | (r[b + 2] << 8) |
                     r[b + 3];
  return (x << (pos & 7)) >> (32 - width);
}

// extract_mac_fields' outcome: the INFO bits, and the network identity.
__device__ uint32_t mac_info(const Row& r, uint32_t* network) {
  const int nbits = 8 * r.n;
  *network = 0u;
  if (nbits < 8) return 0u;
  const uint32_t t = r[0] >> 6, e = (r[0] >> 4) & 3u;
  const uint32_t mcc = row_bits(r, 4, 10), mnc = row_bits(r, 14, 14);
  const bool gate = nbits >= 34 && mcc >= 200u && mcc <= 799u && mnc <= 999u;
  bool ok;
  if (t == 0u)
    ok = nbits >= 35 && (int)row_bits(r, 29, 6) * 8 <= nbits - 19;
  else if (t == 1u)
    ok = true;
  else if (t == 2u)
    ok = e != 0u || gate;
  else
    ok = nbits >= 11 && (int)row_bits(r, 5, 6) * 8 <= nbits + 5;
  if (!ok) return 0u;
  uint32_t info = kMacOk | (t << 3) | (e << 5);
  if (t == 2u && e == 0u) {
    info |= kSysinfo;
    *network = mcc | (mnc << 10) | (row_bits(r, 28, 6) << 24);
  }
  return info;
}

// soft_crc_check on the row's bits (max_errors 2), `ones` its set bits.
__device__ bool soft_crc(const Row& r, int ones, const uint32_t* crc_t) {
  const int n = r.n;
  if (n < 2 || ones == 0 || ones == 8 * n) return false;
  const uint32_t received = (r[n - 2] << 8) | r[n - 1];
  uint32_t crc = 0xFFFFu;
  for (int i = 0; i < n - 2; ++i)
    crc = ((crc << 8) ^ crc_t[((crc >> 8) ^ r[i]) & 0xFFu]) & 0xFFFFu;
  if (__popc(crc ^ received) <= 2) return true;
  crc = 0xFFFFu;                      // the payload's bits reversed
  for (int i = n - 3; i >= 0; --i)
    crc = ((crc << 8) ^ crc_t[((crc >> 8) ^ (__brev(r[i]) >> 24)) & 0xFFu]) &
          0xFFFFu;
  return __popc(crc ^ received) <= 2;
}

// is_valid_text(bytes [a, m) decoded through the class table `cls`, thr).
__device__ bool valid_text(const Row& r, int a, int m, double thr,
                           const int* cls) {
  const int len = m - a;
  if (len < 2) return false;
  int blank = 0, pv = 0, av = 0;
  bool same = true;
  const uint32_t f = r[a];
  for (int i = a; i < m; ++i) {
    const uint32_t c = r[i];
    const int e = cls[c];
    blank += (e & kLBlank) != 0;
    pv += (e & kLPrint) != 0;
    av += (e & kLAlnum) != 0;
    same &= c == f;
  }
  const double n = (double)len;
  return blank < len && (double)pv / n >= thr && !(len > 4 && same) &&
         (double)av / n > 0.5;
}

// Whether bytes [0, m) are UTF-8 as Python's strict decoder reads it.
__device__ bool utf8(const Row& r, int m) {
  int i = 0;
  while (i < m) {
    const uint32_t c = r[i];
    if (c < 0x80u) {
      ++i;
      continue;
    }
    int need;
    uint32_t lo = 0x80u, hi = 0xBFu;
    if (c >= 0xC2u && c <= 0xDFu) {
      need = 1;
    } else if (c >= 0xE0u && c <= 0xEFu) {
      need = 2;
      if (c == 0xE0u) lo = 0xA0u;
      if (c == 0xEDu) hi = 0x9Fu;
    } else if (c >= 0xF0u && c <= 0xF4u) {
      need = 3;
      if (c == 0xF0u) lo = 0x90u;
      if (c == 0xF4u) hi = 0x8Fu;
    } else {
      return false;
    }
    for (int j = 1; j <= need; ++j) {
      if (i + j >= m) return false;
      const uint32_t d = r[i + j];
      if (d < (j == 1 ? lo : 0x80u) || d > (j == 1 ? hi : 0xBFu))
        return false;
    }
    i += need + 1;
  }
  return true;
}

// unpack_gsm7 of the row's bytes [s, s + nbytes), then strip(): the
// counts of the stripped text.
struct Text {
  int len, ps, as, pv, av, asc;
  bool alpha, same;
};

__device__ Text gsm7_text(const Row& r, int s, int nbytes, const int* table) {
  Text t{0, 0, 0, 0, 0, 0, false, true};
  // whitespace met since the last other character: kept once another
  // follows, dropped at the end (strip)
  int p_len = 0, p_ps = 0, p_as = 0, p_pv = 0, p_av = 0, p_asc = 0;
  bool started = false, escaped = false;
  int first_cp = 0;
  const int septets = 8 * nbytes / 7;
  for (int k = 0; k < septets; ++k) {
    const int bit = 7 * k, idx = bit >> 3;
    uint32_t two = r[s + idx];
    if (idx + 1 < nbytes) two |= r[s + idx + 1] << 8;
    const uint32_t code = (two >> (bit & 7)) & 0x7Fu;
    int e;
    if (escaped) {
      e = table[128 + code];
      escaped = false;
    } else if (code == 0x1Bu) {
      escaped = true;
      continue;
    } else {
      e = table[code];
    }
    if (!(e & kPresent)) continue;
    const int ps = (e & kPrintS) != 0, as = (e & kAlnumS) != 0,
              pv = (e & kPrintV) != 0, av = (e & kAlnumV) != 0,
              asc = (e & kAscii) != 0;
    if (e & kSpace) {
      if (started) {
        ++p_len; p_ps += ps; p_as += as; p_pv += pv; p_av += av;
        p_asc += asc;
      }
      continue;
    }
    if (!started) {
      started = true;
      first_cp = e >> 8;
    } else if (p_len || (e >> 8) != first_cp) {
      t.same = false;
    }
    t.len += p_len + 1; t.ps += p_ps + ps; t.as += p_as + as;
    t.pv += p_pv + pv; t.av += p_av + av; t.asc += p_asc + asc;
    p_len = p_ps = p_as = p_pv = p_av = p_asc = 0;
    t.alpha |= (e & kAlpha) != 0;
  }
  return t;
}

// parse_sds_data's GSM7 last resort on the stripped row (m bytes): the
// first best score_text of the two unpackings (a repeated text scores the
// same, so its dedupe changes nothing), is_valid_text(best, 0.55) and
// the ASCII alphanumeric share.
__device__ bool gsm7_accepts(const Row& r, int m, const int* table) {
  Text best{};
  bool have = false;
  double best_score = 0.0;
  const int udh = (int)r[0];
  const bool has_udh = m >= 2 && udh > 0 && udh + 1 < m;
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && !has_udh) break;
    const Text t = u == 0 ? gsm7_text(r, 0, m, table)
                          : gsm7_text(r, udh + 1, m - udh - 1, table);
    if (t.len == 0) continue;
    const double n = (double)t.len;
    double sc = (double)t.ps / n + (double)t.as / n;
    sc = sc + (t.alpha ? 0.5 : 0.0);
    if (sc > best_score) {
      best_score = sc;
      best = t;
      have = true;
    }
  }
  if (!have) return false;
  const double n = (double)best.len;
  return best.len >= 2 && (double)best.pv / n >= 0.55 &&
         !(best.len > 4 && best.same) && (double)best.av / n > 0.5 &&
         (double)best.asc / n >= 0.75;
}

struct ScoreArgs {
  const uint8_t* plains;     // (K, B, L)
  const uint32_t* v0;        // (B, W) payload words
  const uint32_t* v1;
  const int* lengths;        // (B,)
  const int* table;          // (768,) SCORE_TABLE
  uint32_t n_keys, n_pay, n_words;
  int* out;                  // (3, (K + 1) B)
};

__global__ void __launch_bounds__(kCta) key_score_kernel(const ScoreArgs a) {
  __shared__ int table[kTable];
  __shared__ uint32_t crc_t[256];
  for (int i = threadIdx.x; i < kTable; i += kCta) table[i] = a.table[i];
  for (int i = threadIdx.x; i < 256; i += kCta) {
    uint32_t c = (uint32_t)i << 8;
    for (int j = 0; j < 8; ++j) c = (c & 0x8000u) ? ((c << 1) ^ 0x1021u) : c << 1;
    crc_t[i] = c & 0xFFFFu;
  }
  __syncthreads();
  const size_t rows = (size_t)(a.n_keys + 1) * a.n_pay;
  const size_t row = (size_t)blockIdx.x * kCta + threadIdx.x;
  if (row >= rows) return;
  const uint32_t k = (uint32_t)(row / a.n_pay), b = (uint32_t)(row % a.n_pay);
  const int length = 8 * (int)a.n_words;
  Row r;
  r.n = min(max(a.lengths[b], 0), length);
  r.w0 = a.v0 + (size_t)b * a.n_words;
  r.w1 = a.v1 + (size_t)b * a.n_words;
  r.p = k < a.n_keys ? a.plains + row * length : nullptr;
  const int n = r.n;

  // a pass over the bytes: counts, the byte bitmap, the stripped length
  int printable = 0, heur = 0, ones = 0, last_nz = -1, first_zero = n,
      last_high = -1;
  bool all_ff = true, cp_undefined = false;
  uint32_t seen[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < n; ++i) {
    const uint32_t c = r[i];
    const bool pr = c >= 32u && c <= 126u;
    printable += pr;
    heur += pr || c == 10u || c == 13u;
    ones += __popc(c);
    if (c) last_nz = i;
    else if (first_zero == n) first_zero = i;
    if (c >= 128u) last_high = i;
    all_ff &= c == 0xFFu;
    cp_undefined |= (table[kCp1252 + c] & kLUndefined) != 0;
    seen[c >> 5] |= 1u << (c & 31u);
  }
  int unique = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) unique += __popc(seen[j]);
  const int m = last_nz + 1;               // rstrip(b"\x00")
  const int unique_m = unique - ((seen[0] & 1u) && first_zero >= m);
  const uint32_t first = r[0];

  int score = 2 * printable;
  if (unique > n / 8) score += 30;
  if (m == 0) score -= 50;
  if (all_ff) score -= 50;
  if (n >= 4) {
    if (first != 0u && first != 0xFFu) score += 10;
    if (first == 0x01u || first == 0x02u || first == 0x03u ||
        first == 0x04u || first == 0x05u || first == 0x08u ||
        first == 0x0Au || first == 0x0Cu)
      score += 20;
  }
  if (unique > 1) score += 10;

  // parse_sds_data's branches, in its order
  uint32_t info = 0u;
  if (m > 0) {
    const int* latin = table + kLatin1;
    const bool user = n > 3 && r[1] == 0u;
    bool done = false;
    int sds = 0;
    if (user && first == 0x05u && last_high < 3 &&
        valid_text(r, 3, m, 0.8, latin)) {
      sds = 120; info |= kCount; done = true;          // SDS-1
    }
    if (!done && user && first == 0x07u) {
      info |= kFlag; done = true;                      // GSM-7 user type
    }
    if (!done) {
      if (first == 0x82u) {
        if (valid_text(r, 1, m, 0.8, latin)) {
          sds = 120; info |= kCount; done = true;
        }
      } else if (first == 0x03u) {
        if (last_high < 1 && valid_text(r, 1, m, 0.8, latin)) {
          sds = 120; info |= kCount; done = true;
        }
      } else if (first == 0x83u || first == 0x0Cu) {
        sds = 120; done = true;                        // LIP / LOC / GPS
      }
    }
    if (!done && (double)heur / (double)m > 0.6) {
      // Python's decoders in turn: utf-8, latin-1, ascii, cp1252
      if (last_high >= 0 && utf8(r, m)) {
        info |= kFlag; done = true;
      } else if (valid_text(r, 0, m, 0.6, latin) ||
                 (last_high >= 0 && !cp_undefined &&
                  valid_text(r, 0, m, 0.6, table + kCp1252))) {
        sds = 120; info |= kCount; done = true;
      }
    }
    if (!done && gsm7_accepts(r, m, table)) {
      sds = 120; info |= kCount; done = true;
    }
    if (!done) sds = (m > 8 && (double)unique_m / (double)m > 0.7) ? -20 : 40;
    score += sds;
  }

  if (soft_crc(r, ones, crc_t)) score += 100;
  uint32_t network;
  const uint32_t mac = mac_info(r, &network);
  if (mac) score += 50;
  a.out[row] = score;
  a.out[rows + row] = (int)(info | mac);
  a.out[2 * rows + row] = (int)network;
}

}  // namespace

// plains: (K, B, L) uint8 (K may be 0); v0, v1: (B, W) uint32 payload
// words (L = 8 W); lengths: (B,) int32; table: (768,) int32; out:
// (3, (K + 1) B) int32.
extern "C" int tt_key_score(const void* plains, const void* v0,
                            const void* v1, const void* lengths,
                            const void* table, unsigned n_keys,
                            unsigned n_pay, unsigned n_words, void* out,
                            void* stream) {
  const unsigned long long rows = ((unsigned long long)n_keys + 1) * n_pay;
  if (n_pay == 0u || n_words == 0u || rows >= 0x7FFFFFFFull)
    return (int)cudaErrorInvalidValue;
  const ScoreArgs a{(const uint8_t*)plains, (const uint32_t*)v0,
                    (const uint32_t*)v1, (const int*)lengths,
                    (const int*)table, n_keys, n_pay, n_words, (int*)out};
  const unsigned grid = (unsigned)((rows + kCta - 1) / kCta);
  key_score_kernel<<<grid, kCta, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
