"""Spectrum display math: colormap, peak search, bandwidth, calibration.

Framework-independent re-implementation of the DSP-adjacent logic inside
the reference's WaterfallWidget (tetraear/ui/modern.py:649-1362): the
blue->cyan->yellow->red colormap, sub-bin parabolic peak interpolation,
-6 dB contiguous-region bandwidth estimation, percentile-based display
auto-calibration and the IIR display denoiser.  Both the curses dashboard
and the Qt GUI consume these.
"""

from __future__ import annotations

import numpy as np

# colormap control points (value 0..1 -> RGB), blue->cyan->yellow->red
_STOPS = np.array([
    [0.00, 0, 0, 64],
    [0.25, 0, 64, 255],
    [0.50, 0, 255, 255],
    [0.75, 255, 255, 0],
    [1.00, 255, 0, 0],
], dtype=np.float64)


def colormap_rgb(values: np.ndarray) -> np.ndarray:
    """(N,) values in [0,1] -> (N,3) uint8 RGB (modern.py:965-1041)."""
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    out = np.empty(v.shape + (3,), dtype=np.uint8)
    pos = _STOPS[:, 0]
    for c in range(3):
        out[..., c] = np.interp(v, pos, _STOPS[:, c + 1]).astype(np.uint8)
    return out


def power_spectrum_db(iq: np.ndarray, fft_size: int = 2048) -> np.ndarray:
    """Hann-windowed power spectrum in dBFS, DC-centred
    (modern.py:1919-1943)."""
    n = min(fft_size, len(iq))
    seg = np.asarray(iq[:n]) * np.hanning(n)
    spec = np.fft.fftshift(np.fft.fft(seg, fft_size))
    return 20.0 * np.log10(np.abs(spec) / max(n, 1) + 1e-12)


def find_peak(power_db: np.ndarray, fs: float) -> dict:
    """Peak bin with sub-bin parabolic interpolation
    (modern.py:727-772); returns dict(freq_offset_hz, power_db, bin)."""
    p = np.asarray(power_db, np.float64)
    n = len(p)
    k = int(np.argmax(p))
    offset = 0.0
    if 0 < k < n - 1:
        a, b, c = p[k - 1], p[k], p[k + 1]
        denom = a - 2 * b + c
        if abs(denom) > 1e-12:
            offset = 0.5 * (a - c) / denom
            offset = float(np.clip(offset, -0.5, 0.5))
    bin_hz = fs / n
    freq = (k + offset - n / 2) * bin_hz
    return {"freq_offset_hz": freq, "power_db": float(p[k]),
            "bin": k, "sub_bin": offset}


def estimate_bandwidth(power_db: np.ndarray, fs: float,
                       drop_db: float = 6.0) -> float:
    """-6 dB contiguous-region bandwidth around the peak
    (modern.py:774-857)."""
    p = np.asarray(power_db, np.float64)
    n = len(p)
    k = int(np.argmax(p))
    thresh = p[k] - drop_db
    lo = k
    while lo > 0 and p[lo - 1] >= thresh:
        lo -= 1
    hi = k
    while hi < n - 1 and p[hi + 1] >= thresh:
        hi += 1
    return (hi - lo + 1) * fs / n


def zoom_slice(power_db: np.ndarray, zoom: float) -> np.ndarray:
    """Centered 1/zoom fraction of the spectrum bins (the reference's
    spectrum zoom slider, modern.py:859-921).  zoom <= 1 returns the
    full span; the slice always keeps >= 8 bins."""
    n = len(power_db)
    if zoom <= 1.0 or n < 16:
        return power_db
    keep = max(8, int(round(n / zoom)))
    lo = (n - keep) // 2
    return power_db[lo:lo + keep]


def auto_calibrate(power_db: np.ndarray) -> dict:
    """Display floor/ceiling from power percentiles (modern.py:3792-3887).

    floor = p10 - 5 dB, ceiling = p99 + 10 dB, threshold = p75 + 3 dB."""
    p = np.asarray(power_db, np.float64)
    p10, p75, p99 = np.percentile(p, [10, 75, 99])
    return {"floor_db": float(p10 - 5.0),
            "ceiling_db": float(p99 + 10.0),
            "threshold_db": float(p75 + 3.0)}


class SpectrumDenoiser:
    """Single-pole IIR display smoother, alpha=0.15 (modern.py:929-938)."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha
        self._state: np.ndarray | None = None

    def __call__(self, power_db: np.ndarray) -> np.ndarray:
        p = np.asarray(power_db, np.float64)
        if self._state is None or self._state.shape != p.shape:
            self._state = p.copy()
        else:
            self._state += self.alpha * (p - self._state)
        return self._state.copy()


class WaterfallBuffer:
    """Scrolling waterfall history mapped to RGB rows
    (modern.py:965-1041 QImage semantics, framework-free)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.rows = np.zeros((height, width, 3), dtype=np.uint8)
        self.floor_db = -100.0
        self.ceiling_db = 0.0

    def push(self, power_db: np.ndarray) -> None:
        p = np.asarray(power_db, np.float64)
        if len(p) != self.width:
            idx = np.linspace(0, len(p) - 1, self.width)
            p = np.interp(idx, np.arange(len(p)), p)
        v = (p - self.floor_db) / max(self.ceiling_db - self.floor_db, 1e-9)
        rgb = colormap_rgb(v)
        self.rows[1:] = self.rows[:-1]
        self.rows[0] = rgb
