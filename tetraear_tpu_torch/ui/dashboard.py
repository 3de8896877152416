"""Curses terminal dashboard: live spectrum, frames table, stats.

The always-available UI (the PyQt6 GUI in tetraear_tpu_torch.ui.qt needs a
desktop).  Renders the same event stream the GUI consumes: spectrum rows,
decoded frames, statistics — a terminal analogue of the reference's main
window (tetraear/ui/modern.py:2511-5331).

Run: python -m tetraear_tpu_torch.ui.dashboard --source synthetic
(on the CUDA card; add ``--device cpu`` to run the kernels' plain
versions on the CPU instead).
"""

from __future__ import annotations

import argparse
import curses
import time
from collections import deque

import numpy as np

from tetraear_tpu_torch.ui import spectrum as spec_mod

_BARS = " ▁▂▃▄▅▆▇█"


class Dashboard:
    def __init__(self, stdscr, pipeline, source, title: str):
        self.scr = stdscr
        self.pipeline = pipeline
        self.source = source
        self.title = title
        self.frames = deque(maxlen=128)
        self.spectrum = None
        self.denoise = spec_mod.SpectrumDenoiser()
        from tetraear_tpu_torch.ui.status import TetraStatusTracker
        self.status_tracker = TetraStatusTracker()
        self.last_draw = 0.0
        pipeline.on_frame = self.frames.append
        pipeline.on_spectrum = self._on_spectrum

    def _on_spectrum(self, power_db):
        self.spectrum = self.denoise(power_db)

    def _spectrum_row(self, width: int) -> str:
        if self.spectrum is None:
            return "." * width
        p = self.spectrum
        idx = np.linspace(0, len(p) - 1, width).astype(int)
        cal = spec_mod.auto_calibrate(p)
        v = np.clip((p[idx] - cal["floor_db"])
                    / max(cal["ceiling_db"] - cal["floor_db"], 1e-9), 0, 1)
        return "".join(_BARS[int(x * (len(_BARS) - 1))] for x in v)

    def draw(self) -> None:
        now = time.time()
        if now - self.last_draw < 1.0 / 15:     # 15 FPS cap
            return
        self.last_draw = now
        scr = self.scr
        h, w = scr.getmaxyx()
        scr.erase()
        stats = self.pipeline.stats
        agg = getattr(self.pipeline, "aggregator", None)
        act = ""
        if agg is not None:
            snap = agg.snapshot()
            tgs = ",".join(str(g["talkgroup"]) for g in snap["groups"][:3])
            act = (f" | calls={len(snap['active_calls'])} "
                   f"groups={len(snap['groups'])}"
                   + (f" [{tgs}]" if tgs else ""))
        scr.addnstr(0, 0, f" {self.title}  |  frames={stats.frames} "
                    f"crc={stats.crc_pass} sds={stats.sds_messages} "
                    f"voice={stats.voice_frames} "
                    f"enc={stats.encrypted}/{stats.decrypted}dec{act} ",
                    w - 1, curses.A_REVERSE)
        # TETRA detection strip — same Qt-free state machine as the Qt
        # window's status strip (ui/status.py, modern.py:5221-5302)
        st = self.status_tracker.evaluate(stats.as_dict())
        scr.addnstr(1, 0,
                    f" {st['text']}  |  Sync {st['sync_rate']:.0%} "
                    f"CRC {st['crc_rate']:.0%} "
                    f"Decrypt {st['decrypt_rate']:.0%} ", w - 1)
        scr.addnstr(2, 0, self._spectrum_row(w - 1), w - 1)
        scr.addnstr(3, 0, "-" * (w - 1), w - 1)
        row = 4
        for f in list(self.frames)[-(h - 5):]:
            crc = "+" if f.get("burst_crc") else "x"
            enc = ("DEC" if f.get("decrypted")
                   else "ENC" if f.get("encrypted") else "CLR")
            line = (f"#{f.get('number', 0):<4} "
                    f"{f.get('type_name', '?'):<14} c{f.get('carrier', 0)} "
                    f"crc{crc} {enc}")
            sds = f.get("sds_message")
            if sds:
                line += f"  {sds[:max(0, w - len(line) - 4)]}"
            if row < h - 1:
                scr.addnstr(row, 0, line, w - 1)
                row += 1
        scr.refresh()

    def run(self, max_blocks=None) -> None:
        self.scr.nodelay(True)
        n = 0
        with self.source:
            while max_blocks is None or n < max_blocks:
                block = self.source.read_samples(self.pipeline.block_len)
                if len(block) < self.pipeline.block_len:
                    break
                # compute spectrum even when the gate is off
                self._on_spectrum(spec_mod.power_spectrum_db(block))
                self.pipeline.process_block(block)
                self.draw()
                n += 1
                if self.scr.getch() in (ord("q"), 27):
                    break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dashboard")
    ap.add_argument("--source", default="synthetic")
    ap.add_argument("-f", "--frequency", type=float, default=392.5)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import open_source

    cfg = PipelineConfig(sample_rate=args.sample_rate * 1e6,
                         frequency=args.frequency * 1e6,
                         detect_gate=False, device=args.device)
    pipe = Pipeline(cfg)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)
    title = f"tetraear-tpu  {args.frequency:.4f} MHz"

    def _run(stdscr):
        Dashboard(stdscr, pipe, src, title).run(args.max_blocks)

    curses.wrapper(_run)
    print(f"frames={pipe.stats.frames} crc_pass={pipe.stats.crc_pass} "
          f"sds={pipe.stats.sds_messages}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
