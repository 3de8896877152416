"""Where viterbi_decode's time goes: SM clocks of its phases.

Builds a copy of ``dsp/csrc/viterbi.cu`` that stamps ``clock64()`` at the
phase boundaries of the first warp of the first CTA (global loads issued,
deinterleave, class-0 ballots and branch sums, forward pass, traceback
and CRC, output), launches it on random soft blocks (a third of the rows
small values in [-2, 2], many ties), checks the outputs against the plain
version and prints each phase's clocks, then the real kernel's launch
alone (CUDA events, launches queued behind a sleep of the card) at a few
batch sizes.  Needs a CUDA device and nvcc; run from the checkout root:

    python -m tetraear_tpu_torch.voice.viterbi_phases
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.voice import viterbi

# the lines before which a stamp goes (the first: after which)
MARKS = ("  const int n_here = n_blocks - b0 >= 2 ? 2 : 1;\n",
         "  // deinterleave the rows into shared memory\n",
         "  // the class-0 signs as bit words (bits 102.. of word 3 stay 0)\n",
         "  int m = ns == 0 ? 0 : -(1 << 28);\n",
         "  if (ns == 0 && half < n_here) {\n",
         "  uint8_t* dst = ordered + b0 * kOrdered;\n")
PHASES = ("loads issued", "deinterleave", "ballots + sums", "forward",
          "traceback + CRC", "output")
SIZES = (1, 2, 170, 8192, 81920)


def stamped_source() -> str:
    src = (ck._CSRC / "viterbi.cu").read_text()
    src = src.replace('#include "common.cuh"',
                      f'#include "{ck._CSRC / "common.cuh"}"\n'
                      "__device__ long long g_clk[8];")
    for k, mark in enumerate(MARKS):
        if src.count(mark) != 1:
            raise RuntimeError(f"viterbi.cu no longer has the line {mark!r}")
        stamp = (f"  if (blockIdx.x == 0 && threadIdx.x == 0) g_clk[{k}] = "
                 "clock64();\n")
        src = src.replace(mark, mark + stamp if k == 0 else stamp + mark)
    end = "  }\n}\n\n}  // namespace"
    src = src.replace(end, "  }\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
                      "g_clk[6] = clock64();\n}\n\n}  // namespace")
    return src + ('extern "C" int tt_clocks(long long* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_clk, "
                  "sizeof(long long) * 8);\n}\n")


def build() -> ctypes.CDLL:
    out = ck.BUILD_DIR.parent / "viterbi_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "viterbi_stamped.cu").write_text(stamped_source())
    r = subprocess.run([ck._nvcc(), *ck._flags("viterbi.cu"), "-shared",
                        "-o", str(out / "libviterbi_stamped.so"),
                        str(out / "viterbi_stamped.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out / "libviterbi_stamped.so"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tt_viterbi.argtypes = [vp] * 4 + [ci] * 2 + [vp]
    lib.tt_viterbi.restype = lib.tt_clocks.restype = ci
    lib.tt_clocks.argtypes = [vp]
    return lib


def soft_blocks(b: int, rng) -> torch.Tensor:
    soft = rng.integers(-127, 128, (b, 432)).astype(np.int32)
    soft[::3] = rng.integers(-2, 3, soft[::3].shape)
    return torch.from_numpy(soft).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("viterbi_phases: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    lib = build()
    rng = np.random.default_rng(1)
    for b in SIZES:
        t = soft_blocks(b, rng)
        o = torch.empty((b, viterbi.ORDERED_BITS), dtype=torch.uint8,
                        device="cuda")
        f = torch.empty((b,), dtype=torch.bool, device="cuda")
        args = (*viterbi.kernel_args(t, o, f), ck._stream(t.device))
        clk = np.zeros(8, np.int64)
        for _ in range(3):
            if lib.tt_viterbi(*args) or lib.tt_clocks(clk.ctypes.data):
                raise RuntimeError("the stamped kernel failed")
        want = viterbi.decode_plain(t)
        if not (torch.equal(o, want[0]) and torch.equal(f, want[1])):
            raise RuntimeError(f"B={b}: differs from the plain version")
        d = np.diff(clk[:7])
        print(f"B={b}: SM clocks of the first warp, bit-equal: "
              + ", ".join(f"{p} {int(c)}" for p, c in zip(PHASES, d))
              + f"; total {int(d.sum())}")
    real = ck.build().tt_viterbi
    for b in SIZES:
        t = soft_blocks(b, rng)
        o, f = viterbi.decode(t)
        args = (*viterbi.kernel_args(t, o, f), ck._stream(t.device))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(100):
            real(*args)
        end.record()
        end.synchronize()
        print(f"B={b}: launch alone {start.elapsed_time(end) / 100:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
