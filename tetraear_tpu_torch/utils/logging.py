"""Per-run multi-file logging with colored console output.

Equivalent of the reference's logging setup (tetraear/ui/modern.py:111-170):
six per-run log files (all/app/decoder/codec/audio/frames JSONL) selected by
logger-name prefix, plus a colorized console handler.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class ColoredFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


class _PrefixFilter(logging.Filter):
    """Pass records whose logger name starts with any given prefix."""

    def __init__(self, prefixes):
        super().__init__()
        self.prefixes = tuple(prefixes)

    def filter(self, record):
        return record.name.startswith(self.prefixes)


def default_log_dir() -> Path:
    env = os.environ.get("TETRAEAR_TPU_LOG_DIR")
    if env:
        return Path(env)
    return Path.home() / ".tetraear_tpu_torch" / "logs"


def setup_logging(verbose: bool = False,
                  log_dir: Path | str | None = None) -> Path:
    """Configure root logging; returns the per-run log directory."""
    log_dir = Path(log_dir) if log_dir else default_log_dir()
    run_dir = log_dir / time.strftime("%Y%m%d_%H%M%S")
    run_dir.mkdir(parents=True, exist_ok=True)

    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)

    console = logging.StreamHandler()
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    console.setFormatter(ColoredFormatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"))
    root.addHandler(console)

    fmt = logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s")

    def _file(name: str, prefixes=None, level=logging.DEBUG):
        h = logging.FileHandler(run_dir / f"{name}.log", encoding="utf-8")
        h.setLevel(level)
        h.setFormatter(fmt)
        if prefixes:
            h.addFilter(_PrefixFilter(prefixes))
        root.addHandler(h)

    _file("all")
    _file("app", prefixes=("tetraear_tpu_torch.api", "tetraear_tpu_torch.cli",
                           "tetraear_tpu_torch.ui"))
    _file("decoder", prefixes=("tetraear_tpu_torch.frame",
                               "tetraear_tpu_torch.crypto"))
    _file("codec", prefixes=("tetraear_tpu_torch.voice",))
    _file("audio", prefixes=("tetraear_tpu_torch.voice", "tetraear_tpu_torch.audio"))
    _file("signal", prefixes=("tetraear_tpu_torch.dsp", "tetraear_tpu_torch.ref",
                              "tetraear_tpu_torch.scan", "tetraear_tpu_torch.runtime"))
    return run_dir
