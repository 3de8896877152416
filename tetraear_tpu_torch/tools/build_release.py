"""Build a distributable release archive.

Equivalent of the reference's tools/build_exe.py + create_release_package.py
(PyInstaller onefile + zip): here the deliverable is a source archive of
the PyTorch + CUDA package, version-stamped from git.  It carries the
sources of the CUDA kernels (dsp/csrc) and of the two host libraries
(frame/csrc, voice/csrc), which the package builds at first use; no
build/ directory, shared library or bytecode goes in.  ``build`` checks
that the two host libraries compile (native.py) before it packs.
"""

from __future__ import annotations

import argparse
import subprocess
import tarfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

INCLUDE = [
    "tetraear_tpu_torch", "chip_smoke.py", "pyproject.toml", "README.md",
    "pytest.ini",
]
EXCLUDE_PARTS = {"__pycache__", ".pytest_cache", "build"}
EXCLUDE_SUFFIXES = (".pyc", ".so")


def git_version() -> str:
    """Version from the latest git tag, else short hash (build_exe.py:34)."""
    for cmd in (["git", "describe", "--tags", "--always", "--dirty"],
                ["git", "rev-parse", "--short", "HEAD"]):
        try:
            out = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                 text=True, timeout=10)
            if out.returncode == 0 and out.stdout.strip():
                return out.stdout.strip()
        except OSError:
            pass
    return time.strftime("%Y%m%d")


def build(out_dir: Path, with_codec: bool = True) -> Path:
    version = git_version()
    out_dir.mkdir(parents=True, exist_ok=True)
    if with_codec:
        # raises with the compiler's log when a library does not build
        from tetraear_tpu_torch import native
        native.build("voice")
        native.build("frame")
    name = f"tetraear-tpu-torch-{version}"
    archive = out_dir / f"{name}.tar.gz"

    def keep(ti: tarfile.TarInfo):
        parts = set(Path(ti.name).parts)
        if parts & EXCLUDE_PARTS:
            return None
        if ti.name.endswith(EXCLUDE_SUFFIXES):
            return None
        return ti

    with tarfile.open(archive, "w:gz") as tf:
        for item in INCLUDE:
            src = REPO / item
            if src.exists():
                tf.add(src, arcname=f"{name}/{item}", filter=keep)
    return archive


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="build-release")
    ap.add_argument("-o", "--output-dir", default="dist")
    ap.add_argument("--no-codec", action="store_true")
    args = ap.parse_args(argv)
    archive = build(Path(args.output_dir), with_codec=not args.no_codec)
    print(f"[+] release archive: {archive} "
          f"({archive.stat().st_size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
