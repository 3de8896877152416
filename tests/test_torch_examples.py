"""The port's example scripts (tetraear_tpu_torch/examples) on the CPU.

Each example's ``main([..., "--device", "cpu"])`` runs in process and is
held to what tests/integration/test_examples.py asks of the JAX scripts
("EXAMPLE CAPTURE", "FIXTURE CAPTURE OK", "SECRET FIX MSG", "COVERT OPS
GO", the worker count, the sync hits), and, where the JAX script is
quick on the CPU, to that script's own output on the same input: its
decoded lines, its per-carrier summaries, its scan table and the voice
WAV's PCM bit for bit.  The JAX scripts run in process too (``runpy``
with their ``sys.argv``).
"""

import contextlib
import io
import runpy
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("decode_capture", "offair_fixture", "dense_fleet",
            "wideband_scan", "voice_roundtrip", "sharded_deployment")


def _port(name: str, *argv: str) -> tuple:
    """(exit code, stdout) of the port's example on the CPU."""
    import importlib
    mod = importlib.import_module(f"tetraear_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([*argv, "--device", "cpu"])
    return rc, buf.getvalue()


def _jax(name: str, *argv: str, monkeypatch) -> tuple:
    """(exit code, stdout) of the JAX package's script examples/<name>.py
    run as __main__, its timing recovery with the port's repaired clock
    wrap (``torch_jax_repaired``)."""
    from torch_jax_repaired import jax_timing_recover_repaired
    from tetraear_tpu.dsp import timing
    monkeypatch.setattr(timing, "timing_recover",
                        jax_timing_recover_repaired())
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    rc = 0
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                           run_name="__main__")
        except SystemExit as e:
            rc = e.code or 0
    return rc, buf.getvalue()


def _pcm(path: Path) -> np.ndarray:
    with wave.open(str(path)) as wf:
        assert wf.getframerate() == 8000
        return np.frombuffer(wf.readframes(wf.getnframes()), np.int16)


def test_decode_capture(monkeypatch):
    rc, out = _port("decode_capture")
    assert rc == 0
    assert "EXAMPLE CAPTURE" in out and "SDS messages" in out
    assert "[*] 5 frames, 5 CRC-valid, 5 SDS messages" in out
    jrc, jout = _jax("decode_capture", monkeypatch=monkeypatch)
    assert jrc == 0
    # the first line names where the demo capture was written
    assert out.splitlines()[1:] == jout.splitlines()[1:]


def test_decode_capture_of_a_file(tmp_path):
    """A capture named on the command line is decoded as the demo is."""
    from tetraear_tpu_torch.examples import decode_capture
    path = tmp_path / "demo.cfile"
    decode_capture.make_demo_capture(path)
    rc, out = _port("decode_capture", str(path))
    assert rc == 0
    assert out.splitlines() == _port("decode_capture")[1].splitlines()[1:]


def test_offair_fixture(monkeypatch):
    rc, out = _port("offair_fixture")
    assert rc == 0
    assert "FIXTURE CAPTURE OK" in out and "SECRET FIX MSG" in out
    assert "10 decrypted" in out
    assert out == _jax("offair_fixture", monkeypatch=monkeypatch)[1]


def test_dense_fleet(monkeypatch):
    rc, out = _port("dense_fleet")
    assert rc == 0
    assert "COVERT OPS GO" in out and "ENGINE 4 ON SCENE" in out
    assert "3 frame workers" in out and "4 decrypted" in out
    assert out == _jax("dense_fleet", monkeypatch=monkeypatch)[1]


def test_wideband_scan(monkeypatch):
    rc, out = _port("wideband_scan")
    assert rc == 0
    lines = out.splitlines()
    assert lines[-1] == ("[*] expected [392.2125, 392.5375, 392.9625] -> "
                         "found [392.2125, 392.5375, 392.9625]")
    jrc, jout = _jax("wideband_scan", monkeypatch=monkeypatch)
    assert jrc == 0
    # the table; the last line prints the found list (numpy scalars there)
    assert lines[:-1] == jout.splitlines()[:-1]


def test_voice_roundtrip(tmp_path, monkeypatch):
    """The WAV's PCM equals the JAX script's bit for bit."""
    rc, out = _port("voice_roundtrip", str(tmp_path / "port.wav"))
    assert rc == 0
    assert "[*] decoded 6 voice slots -> 2880 samples -> port.wav" in out
    got = _pcm(tmp_path / "port.wav")
    assert len(got) == 2880 and np.abs(got.astype(np.int32)).max() > 1000
    jrc, _ = _jax("voice_roundtrip", str(tmp_path / "jax.wav"),
                  monkeypatch=monkeypatch)
    assert jrc == 0
    np.testing.assert_array_equal(got, _pcm(tmp_path / "jax.wav"))


def test_sharded_deployment():
    """The virtual mesh of eight CPU entries: the (2, 4) demodulator
    finds sync, the voice mesh decodes three frames' PCM, the key search
    scores every frame."""
    rc, out = _port("sharded_deployment")
    assert rc == 0
    assert "[*] 8 mesh entries on cpu" in out
    assert "{'carrier': 2, 'time': 4} mesh" in out
    hits = int(out.split(" sync hits")[0].rsplit(" ", 1)[1])
    assert hits > 0
    assert "720 PCM samples decoded on the 8-entry voice mesh" in out
    assert "8 keys x 64 frames searched" in out


def test_examples_run_as_modules_and_import_quietly(tmp_path):
    """Importing every example prints nothing and runs nothing; one runs
    through python -m."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    code = "".join(f"import tetraear_tpu_torch.examples.{n}\n"
                   for n in EXAMPLES)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == "" and list(tmp_path.iterdir()) == []
    r = subprocess.run([sys.executable, "-m",
                        "tetraear_tpu_torch.examples.wideband_scan",
                        "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "found [392.2125, 392.5375, 392.9625]" in r.stdout


def test_chip_smoke_rehearses_ui_and_examples(tmp_path):
    """chip_smoke.py's ui and examples phases on the CPU (--rehearse:
    the card's runs are CPU runs too): every comparison passes, no
    result line, exit 5, and nothing of JAX is imported."""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                        "--rehearse", "--only", "ui,examples"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 5, (r.stdout[-3000:], r.stderr[-3000:])
    lines = r.stdout.splitlines()
    for head in ("ui gui sds: 7 frames", "ui gui voice: 7 frames",
                 "ui dashboard: 2 blocks"):
        assert any(line.startswith(head) for line in lines), head
    for name in EXAMPLES:
        assert any(line.startswith(f"examples {name}: equal to the CPU run")
                   for line in lines), name
    assert '"ok": true' not in r.stdout and "FAIL" not in r.stdout
