// TEA key search: keys against payloads, decrypt rounds and plaintext
// score in registers, both cipher families in one launch.
//
// Replaces the XLA-compiled uint32 array program of the reference's
// device key search (tetraear_tpu/crypto/batch.py: _tea1_rounds,
// _tea2_rounds, _score_bytes); it has no Pallas counterpart.
//
//   mode 0 (decrypt): out (K1 + K2, B, L) uint8, the plaintext of every
//                     (key, payload) pair, TEA1's keys first;
//   mode 1 (search):  out (K1 + K2, B) int32, _score_bytes of every
//                     pair's plaintext, which never leaves the registers;
//   mode 2 (pairs):   out (B, L) uint8, payload b decrypted with key b
//                     (one family: K1 or K2 is B, the other 0).
//
// Bound by integer operations: a half round is five (TEA2) or six (TEA1)
// instructions, 64 half rounds an 8-byte block, against 8 bytes in and 8
// out.  The rounds are unrolled, so every round's `sum` (and TEA1's
// key-word indices) is a constant of the instruction stream.
//
// Design.  Decrypt and pairs: one thread an 8-byte block.  The flattened
// (key, payload, block) space of each family is indexed so that the W
// blocks of a pair sit on adjacent lanes: a thread's output word is its
// own index, so a warp stores 256 contiguous bytes, and the payload words
// it loads are contiguous too.  Where a thread a pair would leave most
// SMs idle (the live path's 13 + 12 keys x ~1070 payloads), this fills
// them, and a thread's serial chain is one block's 64 half rounds.
// Search: one thread a pair, its W blocks in turn (the score is a sum
// over the payload).  Both modes cover both families in one launch: the
// grid is TEA1's items padded to whole CTAs, then TEA2's, so each CTA's
// family, and its branch, is uniform.  The item -> (key, payload, block)
// divisions by W and B use magic numbers computed on the host
// (crypto/batch.py tea_grid; tests/test_torch_crypto.py replays the map).
// Words are big-endian in the payload (crypto/tea.py); the plaintext's
// bytes are stored with one byte permutation a word.
#include "common.cuh"

namespace {

constexpr uint32_t kDelta = 0x9E3779B9u;
constexpr uint32_t kSum0 = 0xC6EF3720u;        // (kDelta * 32) mod 2^32
constexpr int kCta = 256;

template <bool TEA1>
__device__ __forceinline__ void decrypt_block(uint32_t& v0, uint32_t& v1,
                                              const uint32_t (&k)[4]) {
  uint32_t s = kSum0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (TEA1) {
      v1 -= (((v0 << 4) ^ (v0 >> 5) ^ s) + v0) ^ (k[(s >> 11) & 3] + s);
      s -= kDelta;
      v0 -= (((v1 << 4) ^ (v1 >> 5) ^ s) + v1) ^ (k[s & 3] + s);
    } else {
      v1 -= ((v0 << 4) + k[2]) ^ (v0 + s) ^ ((v0 >> 5) + k[3]);
      s -= kDelta;
      v0 -= ((v1 << 4) + k[0]) ^ (v1 + s) ^ ((v1 >> 5) + k[1]);
    }
  }
}

// bytes of w in [32, 126]
__device__ __forceinline__ int printable4(uint32_t w) {
  return __popc(__vcmpgeu4(w, 0x20202020u) & __vcmpleu4(w, 0x7E7E7E7Eu)) >> 3;
}

// n / d for any n < 2^32, with (m, s) from crypto/batch.py _magic(d)
__device__ __forceinline__ uint32_t fastdiv(uint32_t n, uint32_t m,
                                            uint32_t s) {
  return (uint32_t)(((unsigned long long)__umulhi(n, m) + n) >> s);
}

struct Grid {
  const uint32_t* v0;        // (B, W) payload words
  const uint32_t* v1;
  const uint32_t* kw1;       // (K1, 5) TEA1 key words (the rounds read 4)
  const uint32_t* kw2;       // (K2, 4) TEA2/3/4 key words
  void* out;
  uint32_t ctas1;            // CTAs of TEA1's items; TEA2's follow
  uint32_t n1, n2;           // items of each family; TEA2's output follows
  uint32_t n_pay, n_words;
  uint32_t pay_m, pay_s;     // division by B
  uint32_t words_m, words_s; // division by W
};

template <bool TEA1, int MODE>
__device__ __forceinline__ void item(const Grid& g, uint32_t i) {
  const uint32_t* kw = TEA1 ? g.kw1 : g.kw2;
  const int key_words = TEA1 ? 5 : 4;
  uint32_t k, b, w = 0;
  if (MODE == 1) {                     // a pair: i = k * B + b
    k = fastdiv(i, g.pay_m, g.pay_s);
    b = i - k * g.n_pay;
  } else {                             // a block: i = pair * W + w
    const uint32_t pair = fastdiv(i, g.words_m, g.words_s);
    w = i - pair * g.n_words;
    if (MODE == 2) {
      k = b = pair;
    } else {
      k = fastdiv(pair, g.pay_m, g.pay_s);
      b = pair - k * g.n_pay;
    }
  }
  uint32_t key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) key[j] = __ldg(kw + (size_t)k * key_words + j);
  const size_t src = (size_t)b * g.n_words;
  const size_t dst = (size_t)(TEA1 ? 0u : g.n1) + i;
  if (MODE != 1) {
    uint32_t a = __ldg(g.v0 + src + w), c = __ldg(g.v1 + src + w);
    decrypt_block<TEA1>(a, c, key);
    // big-endian words: byte 0 of the block is a's top byte
    static_cast<uint2*>(g.out)[dst] =
        make_uint2(__byte_perm(a, 0, 0x0123), __byte_perm(c, 0, 0x0123));
    return;
  }
  int printable = 0;
  bool nonzero = false, nonff = false;
  uint32_t first = 0;
  for (uint32_t j = 0; j < g.n_words; ++j) {
    uint32_t a = __ldg(g.v0 + src + j), c = __ldg(g.v1 + src + j);
    decrypt_block<TEA1>(a, c, key);
    printable += printable4(a) + printable4(c);
    nonzero |= (a | c) != 0u;
    nonff |= (a & c) != 0xFFFFFFFFu;
    if (j == 0) first = a >> 24;
  }
  int score = 2 * printable + ((nonzero && nonff) ? 30 : -50);
  if (first != 0u && first != 0xFFu) score += 10;
  const bool tetra = first == 0x01u || first == 0x02u || first == 0x03u ||
                     first == 0x04u || first == 0x05u || first == 0x08u ||
                     first == 0x0Au || first == 0x0Cu || first == 0x82u ||
                     first == 0x83u || first == 0x07u;
  if (tetra) score += 20;
  static_cast<int*>(g.out)[dst] = score;
}

template <int MODE>
__global__ void __launch_bounds__(kCta) tea_kernel(const Grid g) {
  if (blockIdx.x < g.ctas1) {          // uniform across the CTA
    const uint32_t i = blockIdx.x * kCta + threadIdx.x;
    if (i < g.n1) item<true, MODE>(g, i);
  } else {
    const uint32_t i = (blockIdx.x - g.ctas1) * kCta + threadIdx.x;
    if (i < g.n2) item<false, MODE>(g, i);
  }
}

}  // namespace

// v0, v1: (B, W) uint32 payload words; kw1: (K1, 5) TEA1 key words, kw2:
// (K2, 4) TEA2/3/4 key words (either family may have no keys).  The
// grid's numbers (the CTAs and items of each family, the magic numbers of
// the divisions by B and W) come from crypto/batch.py tea_grid.
extern "C" int tt_tea(int mode, const void* v0, const void* v1,
                      const void* kw1, const void* kw2, unsigned ctas1,
                      unsigned ctas2, unsigned n1, unsigned n2,
                      unsigned n_pay, unsigned n_words, unsigned pay_m,
                      unsigned pay_s, unsigned words_m, unsigned words_s,
                      void* out, void* stream) {
  if (mode < 0 || mode > 2 || ctas1 + ctas2 == 0u ||
      (unsigned long long)ctas1 + ctas2 > 0x7FFFFFFFull)
    return (int)cudaErrorInvalidValue;
  const Grid g{(const uint32_t*)v0, (const uint32_t*)v1,
               (const uint32_t*)kw1, (const uint32_t*)kw2, out, ctas1, n1,
               n2, n_pay, n_words, pay_m, pay_s, words_m, words_s};
  const unsigned grid = ctas1 + ctas2;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    tea_kernel<0><<<grid, kCta, 0, s>>>(g);
  else if (mode == 1)
    tea_kernel<1><<<grid, kCta, 0, s>>>(g);
  else
    tea_kernel<2><<<grid, kCta, 0, s>>>(g);
  return (int)cudaGetLastError();
}
