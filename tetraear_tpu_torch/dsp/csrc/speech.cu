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
// This kernel runs that C++ decoder's own code (speech.cuh).
//
// Design: one thread a slot.  The thread reads its slot's state (int32
// words of Word16 values) from device memory into a Decoder in local
// memory once, decodes its frames, and writes the state back once.  The
// kernel takes a list of active slots, so an idle slot costs no thread.
//
// Bound: integer instructions.  A frame is some tens of thousands of
// basicops, each a short dependent chain (the synthesis filters and the
// 32-tap interpolation are sample recursions), so one thread's frames
// form one long serial chain: at small slot counts the latency of that
// chain, not the card's instruction rate, sets the time.  Faster forms
// (a warp a slot for the codebook and LPC work, the state in shared
// memory, independent slots interleaved in one thread) are later work.
#include "common.cuh"
#include "speech.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
acelp_kernel(const int32_t* __restrict__ frames,
             const uint8_t* __restrict__ valid,
             const int32_t* __restrict__ rows, int n_active, int n_frames,
             int32_t* old_exc, int32_t* lspold, int32_t* lspnew,
             int32_t* mem_syn, int32_t* old_parm, int32_t* old_t0,
             int32_t* last_pit, int32_t* last_cod,
             int32_t* __restrict__ pcm) {
  using namespace ttsp;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= n_active) return;
  const long long s = rows[a];

  Decoder d;
  for (int i = 0; i < EXC_LEN; i++)
    d.old_exc[i] = (Word16)old_exc[s * EXC_LEN + i];
  for (int i = 0; i < 10; i++) {
    d.lspold[i] = (Word16)lspold[s * 10 + i];
    d.lspnew[i] = (Word16)lspnew[s * 10 + i];
    d.mem_syn[i] = (Word16)mem_syn[s * 10 + i];
  }
  for (int i = 0; i < 23; i++) d.old_parm[i] = (Word16)old_parm[s * 23 + i];
  d.old_t0 = (Word16)old_t0[s];
  d.last_ener_pit = (Word16)last_pit[s];
  d.last_ener_cod = (Word16)last_cod[s];
  Fac_Pond(0x6000, d.f_gamma3);
  Fac_Pond(0x6ccd, d.f_gamma4);

  for (int f = 0; f < n_frames; f++) {
    const long long af = (long long)a * n_frames + f;
    int32_t* out = pcm + af * L_FRAME;
    if (!valid[af]) {
      for (int i = 0; i < L_FRAME; i++) out[i] = 0;
      continue;
    }
    Word16 prm[24];
    bits2prm(frames + af * N_BITS, prm);
    Word16 synth[L_FRAME];
    d.decode(prm, synth);
    for (int i = 0; i < L_FRAME; i++) out[i] = add(synth[i], synth[i]);
  }

  for (int i = 0; i < EXC_LEN; i++) old_exc[s * EXC_LEN + i] = d.old_exc[i];
  for (int i = 0; i < 10; i++) {
    lspold[s * 10 + i] = d.lspold[i];
    lspnew[s * 10 + i] = d.lspnew[i];
    mem_syn[s * 10 + i] = d.mem_syn[i];
  }
  for (int i = 0; i < 23; i++) old_parm[s * 23 + i] = d.old_parm[i];
  old_t0[s] = d.old_t0;
  last_pit[s] = d.last_ener_pit;
  last_cod[s] = d.last_ener_cod;
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
  const unsigned grid = (unsigned)((n_active + kThreads - 1) / kThreads);
  acelp_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)frames, (const uint8_t*)valid, (const int32_t*)rows,
      n_active, n_frames, (int32_t*)old_exc, (int32_t*)lspold,
      (int32_t*)lspnew, (int32_t*)mem_syn, (int32_t*)old_parm,
      (int32_t*)old_t0, (int32_t*)last_pit, (int32_t*)last_cod,
      (int32_t*)pcm);
  return (int)cudaGetLastError();
}
