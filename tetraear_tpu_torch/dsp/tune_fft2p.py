"""Time fft2p under other plans than ``cuda_kernels.fft2p_plan`` picks.

    python -m tetraear_tpu_torch.dsp.tune_fft2p [n1 n2 ...]

For each (n1, n2) geometry (default: 2048 2048 and 8192 4096, the
C=1024 and C=10240 windows) it runs the kernel with every tile-width
pair that fits a block, with the two passes' lengths as they are and
exchanged and with pass 2 in clusters of 1 to 8 blocks, checks each
result against ``fft2p_plain`` and prints one line per plan: pass 1,
pass 2 and total milliseconds (CUDA events, mean of 5 launches after a
warm-up).  It needs a CUDA device and changes
nothing: the plans are tried by replacing ``fft2p_plan`` for the call.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from tetraear_tpu_torch.dsp import cuda_kernels as ck

TILE_POINTS = 16384          # a tile's padded float2 points fit 139 KB


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plans(n1: int, n2: int):
    lgn = int(np.log2(n1 * n2))
    for la, lb in ((n2, n1), (n1, n2)):
        widths = [(t1, t2) for t1 in (1, 2, 4, 8, 16, 32)
                  for t2 in (1, 2, 4, 8, 16, 32)
                  if la * t1 <= TILE_POINTS and lb * t2 <= TILE_POINTS
                  and la * t1 * 4 >= TILE_POINTS // 2
                  and lb * t2 * 4 >= TILE_POINTS // 2]
        for t1, t2 in widths:
            for cl2 in (1, 2, 4, 8):
                if t2 * cl2 <= 16:
                    yield ck.Fft2pPlan(la, lb, t1, t2, cl2, (lgn + 1) // 2)
        if la == lb:
            return


def tune(n1: int, n2: int, wrap: int = 2) -> None:
    rng = np.random.default_rng(0)
    o2 = 8
    tail = torch.from_numpy(rng.standard_normal(
        (2, o2, n1)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal(
        (2, n2 - o2, n1)).astype(np.float32)).cuda()
    ref = ck.fft2p_plain(tail, x, n1, n2, wrap)
    tol = 1e-4 * ref.double().pow(2).mean().sqrt().item()
    chosen = ck.fft2p_plan(n1, n2)
    real = ck.fft2p_plan
    try:
        for plan in plans(n1, n2):
            ck.fft2p_plan = lambda a, b, plan=plan: plan
            err = (ck.fft2p_planes_spliced(tail, x, n1, n2, wrap)
                   - ref).abs().max().item()
            p1 = _ms(lambda: ck.fft2p_pass1(tail, x, n1, n2))
            tot = _ms(lambda: ck.fft2p_planes_spliced(tail, x, n1, n2,
                                                      wrap))
            print(f"fft2p {n1} x {n2} {plan}: pass 1 {p1:.4f} ms, pass 2 "
                  f"{tot - p1:.4f} ms, total {tot:.4f} ms, max err "
                  f"{err:.3e} ({'ok' if err <= tol else 'FAIL'}, tol "
                  f"{tol:.3e}){' <- fft2p_plan' if plan == chosen else ''}",
                  flush=True)
    finally:
        ck.fft2p_plan = real
    win = torch.cat([tail, x], dim=1).reshape(2, -1)
    win_c = torch.complex(win[0], win[1])
    print(f"fft2p {n1} x {n2}: torch.fft.fft "
          f"{_ms(lambda: torch.fft.fft(win_c)):.4f} ms", flush=True)


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("tune_fft2p: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    sizes = [int(a) for a in argv] or [2048, 2048, 8192, 4096]
    for n1, n2 in zip(sizes[::2], sizes[1::2]):
        tune(n1, n2)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
