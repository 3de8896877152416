"""Settings + frequency preset persistence.

Equivalent of the reference's SettingsManager / FrequencyManager
(tetraear/ui/modern.py:326-412): JSON files in a user data directory, with
an environment override for the location.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_SETTINGS = {
    "gain": "auto",
    "sample_rate": 2.4e6,
    "last_frequency": 392.5e6,
    "theme": "dark",
    "save_silence": False,
    "export_mp3": False,
    "audio_device": None,
    "auto_decrypt": True,
    "expected_mcc": None,
    "carrier_offsets_hz": [0.0],
    "records_dir": None,
}

DEFAULT_FREQUENCIES = [
    {"name": "Poland primary", "frequency": 392.5e6},
    {"name": "Poland emergency", "frequency": 382.5e6},
    {"name": "EU civil low", "frequency": 412.5e6},
]


def data_dir() -> Path:
    env = os.environ.get("TETRAEAR_TPU_DATA_DIR")
    if env:
        return Path(env)
    return Path.home() / ".tetraear_tpu"


class SettingsManager:
    """settings.json with defaults merge (modern.py:326-372)."""

    def __init__(self, path: Path | None = None):
        self.path = path or (data_dir() / "settings.json")
        self.settings = dict(DEFAULT_SETTINGS)
        self.load()

    def load(self) -> None:
        try:
            if self.path.exists():
                with open(self.path, encoding="utf-8") as f:
                    stored = json.load(f)
                self.settings.update(stored)
        except (json.JSONDecodeError, OSError) as e:
            logger.warning("failed to load settings: %s", e)

    def save(self) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump(self.settings, f, indent=2)
        except OSError as e:
            logger.warning("failed to save settings: %s", e)

    def get(self, key, default=None):
        return self.settings.get(key, default)

    def set(self, key, value) -> None:
        self.settings[key] = value
        self.save()


class FrequencyManager:
    """frequencies.json preset list (modern.py:374-412)."""

    def __init__(self, path: Path | None = None):
        self.path = path or (data_dir() / "frequencies.json")
        self.frequencies = list(DEFAULT_FREQUENCIES)
        self.load()

    def load(self) -> None:
        try:
            if self.path.exists():
                with open(self.path, encoding="utf-8") as f:
                    self.frequencies = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            logger.warning("failed to load frequencies: %s", e)

    def save(self) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump(self.frequencies, f, indent=2)
        except OSError as e:
            logger.warning("failed to save frequencies: %s", e)

    def add(self, name: str, frequency: float) -> None:
        self.frequencies.append({"name": name, "frequency": frequency})
        self.save()

    def remove(self, name: str) -> None:
        self.frequencies = [f for f in self.frequencies
                            if f.get("name") != name]
        self.save()
