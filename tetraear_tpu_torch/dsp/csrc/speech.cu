// ACELP speech decoding (EN 300 395-2) of a bank of decoder slots: for
// each active slot, F frames of [BFI + 137 serial bits] in order, each
// unpacked (Bits2prm), decoded (LSP decode and interpolation, Lsp_Az,
// the four subframes' Pred_Lt, D_D4i60, pitch sharpening, gains, Syn_Filt,
// the BFI concealment branches) and post-processed (x2) into 240 PCM
// samples; an invalid frame leaves the slot's state untouched and gives
// zeros.
//
// Replaces the XLA program of the reference's batched decoder
// (tetraear_tpu/voice/jspeech.py decode_block, lax.scans over samples
// around saturating basicops; it has no Pallas kernel), which is
// bit-exact against the C++ decoder (voice/csrc/etsi_acelp_dec.cpp).
// This kernel gives that decoder's words (the steps in speech.cuh).
//
// What bounds it: latency.  A slot's frames are one serial chain; the
// card has work for a few warps (about 110 active slots in a live block)
// and nothing to hide a dependent chain behind.  One thread a slot (the
// first form) walked ~147,000 instructions a frame at 5-6 cycles each,
// ~830,000 cycles.  What is serial by nature is much shorter:
//   * the synthesis filter, 240 samples a frame, each four dependent
//     instructions after the last output (one multiply-add, a shift, a
//     clamp: syn_filt_pass), plus the pass's set-up a subframe; the
//     synth_chain probe at the end of this file runs this chain alone
//     and reads its SM clocks (chip_smoke.py prints them, a subframe
//     and a sample, and takes the kernel's floor from them);
//   * the excitation chain, four times a frame: Pred_Lt (a round of
//     lanes for each run of independent samples), the energy of the
//     prediction (a warp reduction), Log2 / Pow2 for the pitch gain (one
//     scalar chain of ~50 basic operations), the gain update (a sample a
//     lane): of the same order a subframe.
// The two run side by side, so a subframe costs the longer of them.
// Everything else depends on the frame's parameters alone.
//
// Design: a CTA of two warps a slot, the slot's state in shared memory,
// read once and written once a launch; the grid is the list of active
// slots, so an idle slot costs nothing.  The frames go in passes of up
// to kChunk frames:
//   1. Bits2prm, a (frame, parameter) pair a thread;
//   2. a thread a frame decodes what a good frame's parameters alone
//      give (its LSPs, its pitch lags); then a thread of each warp walks
//      the pass's frames for what is serial over frames but cheap: one
//      the LSP chain with its BFI / bad-order concealment, the replayed
//      parameters and a BFI frame's lag, the other the predicted
//      energies (Ener_Update or the BFI decrement) after each subframe;
//   3. a subframe a thread (up to 4 kChunk = 64 at once): Int_Lpc4's
//      interpolation and Lsp_Az, Pond_Ai, Lpc_Gain, the weighted impulse
//      response and its pitch sharpening, D_D4i60, the code energy and
//      gain_cod;
//   4. the chain, one step a subframe: warp 0 runs the excitation chain
//      of subframe t while warp 1 runs the synthesis filter of subframe
//      t - 1 (one lane; the warp writes the PCM), a CTA barrier a step.
//      The pass's excitation is one linear buffer behind the EXC_OFF
//      history words, so no step moves words another step reads.
// Sums the kernel takes in another order than the reference (the
// filters, the interpolation, the energies) use speech.cuh's exact
// reorderings, with the step-by-step chain as the redo where a bound
// fails, so the words are the reference's for every input.
#include "common.cuh"
#include "speech.cuh"

namespace {

using namespace ttsp;

constexpr int kThreads = 64;            // two warps a slot
constexpr int kChunk = 16;              // frames a pass
constexpr int kSub = 4 * kChunk;        // subframes a pass
constexpr int kLin = EXC_OFF + kChunk * L_FRAME;
constexpr int kHStride = L_SUBFR + 1;

struct Shared {
  Word16 exc[kLin];                     // history + the pass's frames
  Word16 code[kSub][L_SUBFR];           // algebraic code vectors
  Word16 h[kSub][kHStride];             // a thread's impulse responses
  Word16 a[kSub][11];                   // LPC of each subframe
  Word16 x[kSub][11];                   // filter inputs (Ap3, impulse)
  uint8_t bits[kChunk][N_BITS];         // [BFI, 137 serial bits]
  Word16 prm[kChunk][24];               // [BFI, 23 parameters]
  Word16 par0[23];                      // old_parm when the pass began
  int8_t src[kChunk];                   // the frame whose parameters a
                                        // frame decodes (-1: par0)
  uint8_t bad[kChunk];                  // the LSPs failed the order test
  Word16 t0_frame[kChunk][4], frac_frame[kChunk][4];  // a good frame's
  Word16 lsp[kChunk][20];               // lspold, lspnew of each frame
  // each subframe of the pass's valid frames, in order
  Word16 frame[kSub];
  Word16 t0[kSub], frac[kSub], last_pit[kSub], last_cod[kSub];
  Word16 g_lpc[kSub], exp_lpc[kSub], gain_cod[kSub];
  uint16_t exc_max[kSub];               // max |exc| of each subframe
  Word16 ysyn[L_SUBFR];
  Word16 f_gamma3[10], f_gamma4[10];
  // the slot's state
  Word16 lspold[10], lspnew[10], mem_syn[10], old_parm[23];
  Word16 old_t0, last_ener_pit, last_ener_cod;
  uint8_t valid[kChunk];
  int n_sub;
};

// Step 2a (a thread a frame): what a good frame decodes from its own
// parameters, the LSPs before the ordering test and the pitch lags.
__device__ void frame_params(Shared& sh, int f) {
  if (!sh.valid[f] || sh.prm[f][0] != 0) return;
  sh.bad[f] = D_Lsp334_cand(sh.prm[f] + 1, sh.lsp[f] + 10);
  pitch_lags(sh.prm[f] + 1, sh.t0_frame[f], sh.frac_frame[f]);
}

// Step 2b (one thread): the pass's frames in order, for what is serial
// over frames: the LSPs (a bad set or a BFI frame keeps the last ones),
// which frame's parameters each frame decodes (a BFI frame replays the
// last good one's), a BFI frame's pitch lag (the last frame's).
__device__ void serial_params(Shared& sh, int nf) {
  Word16 lspold[10], lspnew[10];
  for (int i = 0; i < 10; i++) {
    lspold[i] = sh.lspold[i];
    lspnew[i] = sh.lspnew[i];
  }
  for (int i = 0; i <= 22; i++) sh.par0[i] = sh.old_parm[i];
  int ns = 0, last_good = -1;
  Word16 old_t0 = sh.old_t0;
  for (int f = 0; f < nf; f++) {
    if (!sh.valid[f]) continue;
    const bool bfi = sh.prm[f][0] != 0;
    const bool keep = bfi || sh.bad[f];
    for (int i = 0; i < 10; i++) {
      const Word16 cand = sh.lsp[f][10 + i];
      sh.lsp[f][i] = lspold[i];
      if (!bfi) lspnew[i] = keep ? lspold[i] : cand;
      else if (i > 0) lspnew[i] = lspold[i];
      sh.lsp[f][10 + i] = lspnew[i];
      lspold[i] = lspnew[i];
    }
    if (!bfi) last_good = f;
    sh.src[f] = (int8_t)last_good;
    for (int k = 0; k < 4; k++, ns++) {
      sh.frame[ns] = (Word16)f;
      sh.t0[ns] = bfi ? old_t0 : sh.t0_frame[f][k];
      sh.frac[ns] = bfi ? 0 : sh.frac_frame[f][k];
    }
    old_t0 = sh.t0[ns - 1];
  }
  for (int i = 0; i < 10; i++) {
    sh.lspold[i] = lspold[i];
    sh.lspnew[i] = lspnew[i];
  }
  if (last_good >= 0)
    for (int i = 0; i <= 22; i++) sh.old_parm[i] = sh.prm[last_good][1 + i];
  sh.old_t0 = old_t0;
  sh.n_sub = ns;
}

// Step 2, beside it (another warp's thread): the predicted energies after
// each subframe, Ener_Update from the gain index or the BFI decrement (a
// BFI frame's index is never read)
__device__ void serial_energies(Shared& sh, int nf) {
  int ns = 0;
  for (int f = 0; f < nf; f++) {
    if (!sh.valid[f]) continue;
    for (int k = 0; k < 4; k++, ns++) {
      Ener_Update(sh.prm[f][1 + 7 + 5 * k], sh.prm[f][0], &sh.last_ener_pit,
                  &sh.last_ener_cod);
      sh.last_pit[ns] = sh.last_ener_pit;
      sh.last_cod[ns] = sh.last_ener_cod;
    }
  }
}

// Step 3 (a thread a subframe): everything of subframe s that does not
// read the excitation.
__device__ void subframe_params(Shared& sh, int s) {
  const int f = sh.frame[s], k = s & 3;
  const Word16* p = (sh.src[f] < 0 ? sh.par0 : sh.prm[sh.src[f]] + 1)
                    + 3 + 5 * k;
  Word16* a = sh.a[s];
  Int_Lpc_sub(sh.lsp[f], sh.lsp[f] + 10, k, a);
  Word16 ap3[11], ap4[11], zero[10];
  Pond_Ai(a, sh.f_gamma3, ap3);
  Pond_Ai(a, sh.f_gamma4, ap4);
  for (int i = 0; i < 10; i++) zero[i] = 0;

  // Lpc_Gain: the energy of 1 / A(z)'s impulse response
  Word16* h = sh.h[s];
  Word16* x = sh.x[s];
  x[0] = 0x400;
  syn_filt(a, x, 1, 0x400, h, zero, false);
  const Word32 L = sq_chain(0, h, L_SUBFR);
  const Word16 exp_lpc = norm_l(L);
  const Word16 g_lpc = extract_h(L_shl(L, exp_lpc));

  // the weighted impulse response Ap3 / Ap4, pitch-sharpened
  uint32_t ap3_max = 0;
  for (int i = 0; i <= 10; i++) {
    x[i] = ap3[i];
    const uint32_t m = (uint32_t)(ap3[i] < 0 ? -(Word32)ap3[i] : ap3[i]);
    ap3_max = m > ap3_max ? m : ap3_max;
  }
  syn_filt(ap4, x, 11, ap3_max, h, zero, false);
  const Word16 t0 = sh.t0[s];
  // (a BFI frame's lag comes from the state: one that no decoder left
  // must read neither before h nor past its row)
  for (int i = t0 < 0 ? 0 : t0; i <= 59 && i - t0 <= 59; i++)
    h[i] = add(h[i], mult(h[i - t0], 0x6668));

  Word16* code = sh.code[s];
  D_D4i60(p[1], p[2], p[3], h, code);
  const Word16 ener_cod = ener_cod_of(sq_chain(0, code, L_SUBFR), g_lpc,
                                      exp_lpc);
  sh.g_lpc[s] = g_lpc;
  sh.exp_lpc[s] = exp_lpc;
  sh.gain_cod[s] = gain_cod_of(sh.last_cod[s], ener_cod);
}

// Step 4, warp 0: subframe s's excitation (Pred_Lt, the pitch gain, the
// update) at exc = &sh.exc[EXC_OFF + 60 s].
__device__ void excitation(Shared& sh, int s, int lane) {
  Word16* exc = sh.exc + EXC_OFF + L_SUBFR * s;
  const Word16 t0 = sh.t0[s], frac = sh.frac[s];
  // Pred_Lt: exc[i] reads exc[i - t0 + 16] at most (exc[i - t0] without
  // a fraction), so runs of t0 - 16 (t0) samples are independent: a
  // round of lanes a run.  (A decoded lag is 19..144; without a fraction
  // it may be a BFI frame's from the state, and one that no decoder left
  // must neither stall the rounds nor read outside the buffer.)
  if (frac == 0 || frac == 1 || frac == -1) {
    const int run = frac == 0 ? t0 : t0 - 16;
    const int step = run < 1 ? 1 : (run < 32 ? run : 32);
    const int first = -(EXC_OFF + L_SUBFR * s), last = kLin - 1 + first;
    for (int i0 = 0; i0 < L_SUBFR; i0 += step) {
      const int i = i0 + lane;
      const int j = i - t0 < first ? first : (i - t0 > last ? last : i - t0);
      if (lane < step && i < L_SUBFR)
        exc[i] = frac == 0 ? exc[j] : Inter32(&exc[i - t0], frac);
      __syncwarp();
    }
  }
  // the prediction's energy, from 1: a warp sum of squares
  uint32_t e = 0;
  for (int i = lane; i < L_SUBFR; i += 32)
    e += (uint32_t)((Word32)exc[i] * exc[i]);
  e = e > 0x7fffffffu ? 0x7fffffffu : e;
  for (int off = 16; off > 0; off >>= 1)
    e = sat_add_pos(e, __shfl_xor_sync(0xffffffffu, e, off));
  const Word32 L = (Word32)sat_add_pos(e, 1);
  const Word16 ener_pit = ener_pit_of(L, sh.g_lpc[s], sh.exp_lpc[s]);
  const Word16 gain_pit = gain_pit_of(sh.last_pit[s], ener_pit);
  const Word16 gain_cod = sh.gain_cod[s];
  const Word16* code = sh.code[s];
  // the update, and its largest magnitude for the synthesis filter
  uint32_t m = 0;
  for (int i = lane; i < L_SUBFR; i += 32) {
    Word32 Lx = L_mult0(gain_pit, exc[i]);
    Lx = L_mac0(Lx, gain_cod, code[i]);
    const Word16 v = (Word16)L_shr_r(Lx, 12);
    exc[i] = v;
    const uint32_t u = (uint32_t)(v < 0 ? -(Word32)v : v);
    m = u > m ? u : m;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  if (lane == 0) sh.exc_max[s] = (uint16_t)m;
}

// Step 4, warp 1: subframe s's synthesis (lane 0) and its PCM (x2).
__device__ void synthesis(Shared& sh, int s, int lane, int32_t* pcm) {
  if (lane == 0)
    syn_filt(sh.a[s], sh.exc + EXC_OFF + L_SUBFR * s, L_SUBFR,
             sh.exc_max[s], sh.ysyn, sh.mem_syn, true);
  __syncwarp();
  int32_t* out = pcm + (long long)sh.frame[s] * L_FRAME + L_SUBFR * (s & 3);
  for (int i = lane; i < L_SUBFR; i += 32) out[i] = add(sh.ysyn[i],
                                                        sh.ysyn[i]);
}

__global__ void __launch_bounds__(kThreads)
acelp_kernel(const int32_t* __restrict__ frames,
             const uint8_t* __restrict__ valid,
             const int32_t* __restrict__ rows, int n_frames,
             int32_t* old_exc, int32_t* lspold, int32_t* lspnew,
             int32_t* mem_syn, int32_t* old_parm, int32_t* old_t0,
             int32_t* last_pit, int32_t* last_cod,
             int32_t* __restrict__ pcm) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long a = blockIdx.x;
  const long long s = rows[a];

  for (int i = tid; i < EXC_OFF; i += kThreads)
    sh.exc[i] = (Word16)old_exc[s * EXC_LEN + i];
  if (tid < 10) {
    sh.lspold[tid] = (Word16)lspold[s * 10 + tid];
    sh.lspnew[tid] = (Word16)lspnew[s * 10 + tid];
    sh.mem_syn[tid] = (Word16)mem_syn[s * 10 + tid];
  }
  if (tid < 23) sh.old_parm[tid] = (Word16)old_parm[s * 23 + tid];
  if (tid == 0) {
    sh.old_t0 = (Word16)old_t0[s];
    sh.last_ener_pit = (Word16)last_pit[s];
    sh.last_ener_cod = (Word16)last_cod[s];
    Fac_Pond(0x6000, sh.f_gamma3);
    Fac_Pond(0x6ccd, sh.f_gamma4);
  }

  for (int f0 = 0; f0 < n_frames; f0 += kChunk) {
    const int nf = n_frames - f0 < kChunk ? n_frames - f0 : kChunk;
    const long long af0 = a * n_frames + f0;
    // 1. Bits2prm: the pass's frames into shared memory (the BFI word
    // and the low bit of each serial word), then parameter q of frame f
    // is the MSB-first integer of its c_tab[kOffBitno + q] serial bits
    for (int j = tid; j < nf * N_BITS; j += kThreads) {
      const int32_t w = frames[af0 * N_BITS + j];
      sh.bits[j / N_BITS][j % N_BITS] =
          (uint8_t)(j % N_BITS == 0 ? w != 0 : w & 1);
    }
    for (int f = tid; f < nf; f += kThreads) sh.valid[f] = valid[af0 + f];
    __syncthreads();
    for (int j = tid; j < nf * 24; j += kThreads) {
      const int f = j / 24, q = j % 24 - 1;
      int v = sh.bits[f][0];
      if (q >= 0) {
        int start = 1;
        for (int r = 0; r < q; r++) start += c_tab[kOffBitno + r];
        v = 0;
        for (int r = 0; r < c_tab[kOffBitno + q]; r++)
          v = (v << 1) | sh.bits[f][start + r];
      }
      sh.prm[f][1 + q] = (Word16)v;
    }
    __syncthreads();
    for (int j = tid; j < nf * L_FRAME; j += kThreads)
      if (!sh.valid[j / L_FRAME]) pcm[af0 * L_FRAME + j] = 0;
    // 2.
    if (tid < nf) frame_params(sh, tid);
    __syncthreads();
    if (tid == 0) serial_params(sh, nf);
    if (tid == 32) serial_energies(sh, nf);
    __syncthreads();
    const int n = sh.n_sub;
    // 3.
    if (tid < n) subframe_params(sh, tid);
    __syncthreads();
    // 4. excitation of subframe t beside the synthesis of t - 1
    for (int t = 0; t <= n; t++) {
      if (warp == 0 && t < n) excitation(sh, t, lane);
      if (warp == 1 && t > 0) synthesis(sh, t - 1, lane, pcm + af0 * L_FRAME);
      __syncthreads();
    }
    if (n > 0) {
      // the state's excitation words after the pass's last frame: the
      // EXC_OFF-word history, then that frame's 240 samples; the next
      // pass starts from the same history
      const int end = EXC_OFF + L_FRAME * (n / 4);
      for (int i = tid; i < EXC_OFF + L_FRAME; i += kThreads)
        old_exc[s * EXC_LEN + i] = sh.exc[i < EXC_OFF ? end - EXC_OFF + i
                                                      : end - L_FRAME + i
                                                            - EXC_OFF];
      Word16 keep[(EXC_OFF + kThreads - 1) / kThreads];
      for (int i = tid, r = 0; i < EXC_OFF; i += kThreads, r++)
        keep[r] = sh.exc[end - EXC_OFF + i];
      __syncthreads();
      for (int i = tid, r = 0; i < EXC_OFF; i += kThreads, r++)
        sh.exc[i] = keep[r];
      __syncthreads();
    }
  }

  if (tid < 10) {
    lspold[s * 10 + tid] = sh.lspold[tid];
    lspnew[s * 10 + tid] = sh.lspnew[tid];
    mem_syn[s * 10 + tid] = sh.mem_syn[tid];
  }
  if (tid < 23) old_parm[s * 23 + tid] = sh.old_parm[tid];
  if (tid == 0) {
    old_t0[s] = sh.old_t0;
    last_pit[s] = sh.last_ener_pit;
    last_cod[s] = sh.last_ener_cod;
  }
}

// The synthesis chain alone, the floor's yardstick: lane 0 runs n
// subframes' syn_filt one after another from shared memory, as warp 1
// of acelp_kernel does, carrying mem, and times them with the SM clock.
__global__ void __launch_bounds__(32)
synth_chain_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ x, int n, int32_t* mem,
                   int32_t* __restrict__ y, long long* cycles) {
  __shared__ Word16 sa[kSub][11], sx[kSub][L_SUBFR], sy[kSub][L_SUBFR];
  __shared__ Word16 smem[10];
  __shared__ uint32_t smax[kSub];
  const int lane = threadIdx.x;
  for (int j = lane; j < n * 11; j += 32) sa[j / 11][j % 11] = (Word16)a[j];
  for (int j = lane; j < n * L_SUBFR; j += 32)
    sx[j / L_SUBFR][j % L_SUBFR] = (Word16)x[j];
  if (lane < 10) smem[lane] = (Word16)mem[lane];
  __syncwarp();
  for (int s = lane; s < n; s += 32) {
    uint32_t m = 0;
    for (int i = 0; i < L_SUBFR; i++) {
      const uint32_t u = (uint32_t)(sx[s][i] < 0 ? -(Word32)sx[s][i]
                                                 : sx[s][i]);
      m = u > m ? u : m;
    }
    smax[s] = m;
  }
  __syncwarp();
  if (lane == 0) {
    const long long t = clock64();
    for (int s = 0; s < n; s++)
      syn_filt(sa[s], sx[s], L_SUBFR, smax[s], sy[s], smem, true);
    *cycles = clock64() - t;
  }
  __syncwarp();
  for (int j = lane; j < n * L_SUBFR; j += 32)
    y[j] = sy[j / L_SUBFR][j % L_SUBFR];
  if (lane < 10) mem[lane] = smem[lane];
}

}  // namespace

// frames: (A, F, 138) int32; valid: (A, F) bool; rows: (A,) int32
// distinct slot indices; the eight state leaves (S, ...) int32 in
// SpeechState order, updated in place for the rows; pcm: (A, F, 240)
// int32.  tab (4643 int16) is the host's table (voice/speech.py),
// copied to constant memory on the stream ahead of the launch.
extern "C" int tt_acelp(const void* frames, const void* valid,
                        const void* rows, int n_active, int n_frames,
                        void* old_exc, void* lspold, void* lspnew,
                        void* mem_syn, void* old_parm, void* old_t0,
                        void* last_pit, void* last_cod, void* pcm,
                        const void* tab, void* stream) {
  if (n_active < 1 || n_frames < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyToSymbolAsync(ttsp::c_tab, tab,
                                          sizeof(ttsp::c_tab), 0,
                                          cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  int32_t coef[66] = {};
  for (int k = 0; k < 64; k++) {
    coef[k] = ((const int16_t*)tab)[ttsp::kOffCoef1 + k];  // Coef2 follows
    coef[64 + k / 32] += coef[k] < 0 ? -coef[k] : coef[k];
  }
  e = cudaMemcpyToSymbolAsync(ttsp::c_coef, coef, sizeof(coef), 0,
                              cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)n_active;
  acelp_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)frames, (const uint8_t*)valid, (const int32_t*)rows,
      n_frames, (int32_t*)old_exc, (int32_t*)lspold, (int32_t*)lspnew,
      (int32_t*)mem_syn, (int32_t*)old_parm, (int32_t*)old_t0,
      (int32_t*)last_pit, (int32_t*)last_cod, (int32_t*)pcm);
  return (int)cudaGetLastError();
}

// a: (n, 11) int32 LPC (Q12) of each subframe, x: (n, 60) int32 inputs,
// mem: (10,) int32 filter memory, updated; y: (n, 60) int32 outputs;
// cycles: (1,) int64, the SM clocks lane 0 took over the n subframes.
extern "C" int tt_synth_chain(const void* a, const void* x, int n,
                              void* mem, void* y, void* cycles,
                              void* stream) {
  if (n < 1 || n > kSub) return (int)cudaErrorInvalidValue;
  synth_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)x, n, (int32_t*)mem, (int32_t*)y,
      (long long*)cycles);
  return (int)cudaGetLastError();
}
