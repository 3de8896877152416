"""GUI key-file parsing (the reference Load-Keys button's file format,
modern.py:3987-4021): one key per line, `#`/`//` comments, any
separators — every hex digit on the line is kept, and candidates of
16-32 hex chars are accepted (the frame decoder's set_keys then
registers 20-char keys as TEA1 and 32-char as TEA2/3/4).
"""

from __future__ import annotations

_HEX = set("0123456789abcdefABCDEF")


def parse_key_text(text: str) -> list[str]:
    """Key-file text -> lowercase hex key strings."""
    keys = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        key = "".join(c for c in line if c in _HEX)
        if 16 <= len(key) <= 32:
            keys.append(key.lower())
    return keys


def load_key_file(path) -> list[str]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_key_text(f.read())
