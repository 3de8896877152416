// TEA key search: every key against every payload, decrypt rounds and
// plaintext score in registers.
//
// Replaces the XLA-compiled uint32 array program of the reference's
// device key search (tetraear_tpu/crypto/batch.py: _tea1_rounds,
// _tea2_rounds, _score_bytes); it has no Pallas counterpart.  One thread
// takes one (key, payload) pair: the key words sit in registers, the
// payload's W 8-byte blocks go through the 32 decrypt rounds one after
// the other, and the rounds are unrolled so that every round's `sum`
// (and TEA1's key-word index, (sum >> 11) & 3 and sum & 3) is a constant
// of the instruction stream.
//
//   mode 0 (decrypt): out (K, B, L) uint8, the plaintext of every pair;
//   mode 1 (search):  out (K, B) int32, _score_bytes of every pair's
//                     plaintext, which never leaves the registers;
//   mode 2 (pairs):   out (B, L) uint8, payload b decrypted with key b.
//
// Bound by integer operations: a half round is about seven (two shifts,
// three-input logic, two additions, a subtraction), 64 half rounds an
// 8-byte block, against 8 bytes in and 8 (decrypt) or 4 / W (search) out.
// Words are big-endian in the payload (crypto/tea.py); the plaintext's
// bytes are stored with one byte permutation a word.
#include "common.cuh"

namespace {

constexpr uint32_t kDelta = 0x9E3779B9u;
constexpr uint32_t kSum0 = 0xC6EF3720u;        // (kDelta * 32) mod 2^32

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

template <bool TEA1, int MODE>
__global__ void __launch_bounds__(256)
tea_kernel(const uint32_t* __restrict__ v0s, const uint32_t* __restrict__ v1s,
           const uint32_t* __restrict__ kw, int key_words, int n_keys,
           int n_pay, int n_words, void* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total =
      MODE == 2 ? (long long)n_pay : (long long)n_keys * n_pay;
  if (i >= total) return;
  const int b = MODE == 2 ? (int)i : (int)(i % n_pay);
  const long long k = MODE == 2 ? i : i / n_pay;
  uint32_t key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) key[j] = __ldg(kw + k * key_words + j);
  const uint32_t* p0 = v0s + (long long)b * n_words;
  const uint32_t* p1 = v1s + (long long)b * n_words;
  int printable = 0;
  bool nonzero = false, nonff = false;
  uint32_t first = 0;
  uint2* dst = static_cast<uint2*>(out) + i * n_words;
  for (int w = 0; w < n_words; ++w) {
    uint32_t a = __ldg(p0 + w), c = __ldg(p1 + w);
    decrypt_block<TEA1>(a, c, key);
    if (MODE == 1) {
      printable += printable4(a) + printable4(c);
      nonzero |= (a | c) != 0u;
      nonff |= (a & c) != 0xFFFFFFFFu;
      if (w == 0) first = a >> 24;
    } else {
      // big-endian words: byte 0 of the block is a's top byte
      dst[w] = make_uint2(__byte_perm(a, 0, 0x0123), __byte_perm(c, 0, 0x0123));
    }
  }
  if (MODE == 1) {
    int score = 2 * printable + ((nonzero && nonff) ? 30 : -50);
    if (first != 0u && first != 0xFFu) score += 10;
    const bool tetra = first == 0x01u || first == 0x02u || first == 0x03u ||
                       first == 0x04u || first == 0x05u || first == 0x08u ||
                       first == 0x0Au || first == 0x0Cu || first == 0x82u ||
                       first == 0x83u || first == 0x07u;
    if (tetra) score += 20;
    static_cast<int*>(out)[i] = score;
  }
}

template <bool TEA1>
void launch(int mode, const uint32_t* v0, const uint32_t* v1,
            const uint32_t* kw, int key_words, int n_keys, int n_pay,
            int n_words, void* out, cudaStream_t stream) {
  const long long total =
      mode == 2 ? (long long)n_pay : (long long)n_keys * n_pay;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (mode == 0)
    tea_kernel<TEA1, 0><<<blocks, 256, 0, stream>>>(v0, v1, kw, key_words,
                                                    n_keys, n_pay, n_words,
                                                    out);
  else if (mode == 1)
    tea_kernel<TEA1, 1><<<blocks, 256, 0, stream>>>(v0, v1, kw, key_words,
                                                    n_keys, n_pay, n_words,
                                                    out);
  else
    tea_kernel<TEA1, 2><<<blocks, 256, 0, stream>>>(v0, v1, kw, key_words,
                                                    n_keys, n_pay, n_words,
                                                    out);
}

}  // namespace

// v0, v1: (B, W) uint32 payload words; kw: (K, key_words) uint32 key words
// (5 for TEA1, of which the rounds read four; 4 for TEA2/3/4).
extern "C" int tt_tea(int mode, int tea1, const void* v0, const void* v1,
                      const void* kw, int key_words, int n_keys, int n_pay,
                      int n_words, void* out, void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (tea1)
    launch<true>(mode, (const uint32_t*)v0, (const uint32_t*)v1,
                 (const uint32_t*)kw, key_words, n_keys, n_pay, n_words, out,
                 (cudaStream_t)stream);
  else
    launch<false>(mode, (const uint32_t*)v0, (const uint32_t*)v1,
                  (const uint32_t*)kw, key_words, n_keys, n_pay, n_words, out,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
