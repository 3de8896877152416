"""Qt-free live TETRA status core (the reference's always-visible
status strip, modern.py:5221-5302 update_tetra_status).

The detection state machine keeps the reference's thresholds:

- no signal / zero frames        -> "none"
- first frames < min_detect_s    -> "analyzing" (countdown)
- >= 3 frames and (sync or CRC rate > 0.1, or >= 5 frames) -> "detected"
- >= 5 frames and (sync > 0.2 or CRC > 0.3 or >= 10 frames)
                                 -> "high" confidence

Frontends (Qt window, curses dashboard) render `evaluate()`'s dict;
the math stays unit-testable without a display.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class TetraStatusTracker:
    min_detect_s: float = 3.0
    first_frame_time: float | None = field(default=None, repr=False)

    def evaluate(self, stats: dict, now: float | None = None) -> dict:
        """Pipeline stats dict -> status dict.

        Returns {state, text, sync_rate, crc_rate, decrypt_rate,
        frames}; state in {"none", "analyzing", "detected", "high"}.
        """
        now = time.time() if now is None else now
        frames = int(stats.get("frames", 0))
        signal = bool(stats.get("signal_present", False))
        if not signal or frames == 0:
            self.first_frame_time = None
            return {"state": "none", "text": "No TETRA Signal",
                    "sync_rate": 0.0, "crc_rate": 0.0,
                    "decrypt_rate": 0.0, "frames": frames}
        if self.first_frame_time is None:
            self.first_frame_time = now
        sync_rate = int(stats.get("valid_frames", 0)) / max(frames, 1)
        crc_rate = int(stats.get("crc_pass", 0)) / max(frames, 1)
        enc = int(stats.get("encrypted", 0))
        decrypt_rate = int(stats.get("decrypted", 0)) / max(enc, 1)
        out = {"sync_rate": sync_rate, "crc_rate": crc_rate,
               "decrypt_rate": decrypt_rate, "frames": frames}
        waited = now - self.first_frame_time
        if waited < self.min_detect_s:
            left = int(self.min_detect_s - waited)
            out.update(state="analyzing",
                       text=f"Signal Detected (Analyzing... {left}s)")
            return out
        validated = sync_rate > 0.1 or crc_rate > 0.1
        detected = frames >= 3 and (validated or frames >= 5)
        high = frames >= 5 and (sync_rate > 0.2 or crc_rate > 0.3
                                or frames >= 10)
        label = (f"{frames} frames, Sync: {sync_rate:.0%}, "
                 f"CRC: {crc_rate:.0%}")
        if high:
            out.update(state="high",
                       text=f"TETRA Signal Detected ({label})")
        elif detected:
            out.update(state="detected", text=f"TETRA Detected ({label})")
        else:
            out.update(state="analyzing", text=f"Decoding... ({label})")
        return out
