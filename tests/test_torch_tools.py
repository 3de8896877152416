"""The port's tools (tetraear_tpu_torch/tools) against the JAX package's.

Each tool runs through both packages on the same input made from a seed,
the port's with ``--device cpu`` (its kernels' plain versions), and their
outputs are compared: the JSONL frames of continuous-capture, the
decryptions decrypt-capture reports, auto-capture's finds and files,
listen-clear's counts and calls, bruteforce-keys' candidate list (from
ONE key search for both cipher families), the key list, the text
ranking, the codec check and the release archive; then the CLI's tool
dispatch.  Each JAX tool runs once here: its Pipeline compiles on the
CPU in a few seconds.
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("listen_clear", "continuous_capture", "decrypt_capture",
         "bruteforce_keys", "generate_common_keys", "analyze_text",
         "verify_codec", "auto_capture", "build_release")


def _tool(pkg: str, name: str):
    import importlib
    return importlib.import_module(f"{pkg}.tools.{name}")


def _run(pkg: str, name: str, argv: list) -> tuple:
    """(rc, stdout) of the tool's main; the port's on the CPU."""
    if pkg == "tetraear_tpu_torch" and name in (
            "continuous_capture", "decrypt_capture", "listen_clear",
            "auto_capture", "bruteforce_keys"):
        argv = [*argv, "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _tool(pkg, name).main(argv)
    return rc, buf.getvalue()


def _both(name: str, argv_of, out_dir: Path | None = None) -> dict:
    """{pkg: (rc, stdout)}; argv_of(pkg) gives each package's arguments,
    ``out_dir / pkg`` (named in the output) reads ``<out>``."""
    runs = {}
    for pkg in ("tetraear_tpu", "tetraear_tpu_torch"):
        rc, out = _run(pkg, name, argv_of(pkg))
        if out_dir is not None:
            out = out.replace(str(out_dir / pkg), "<out>")
        runs[pkg] = (rc, out)
    return runs


# -- continuous-capture ---------------------------------------------------

def test_continuous_capture_frames_equal(tmp_path):
    runs = _both("continuous_capture", lambda pkg: [
        "--source", "synthetic", "--max-blocks", "2",
        "-o", str(tmp_path / pkg)])
    frames = {}
    for pkg, (rc, _) in runs.items():
        assert rc == 0
        logs = list((tmp_path / pkg).glob("continuous_*.jsonl"))
        assert len(logs) == 1
        frames[pkg] = [json.loads(line)
                       for line in logs[0].read_text().splitlines()]
    want, got = frames["tetraear_tpu"], frames["tetraear_tpu_torch"]
    assert len(got) == len(want) >= 4

    def crc_passing(fs):
        return [(sorted(f), f.get("sds_message"), f.get("mac_pdu"))
                for f in fs if f.get("burst_crc")]

    assert crc_passing(got) == crc_passing(want)
    assert any(f.get("sds_message") for f in got)


# -- decrypt-capture ------------------------------------------------------

KEY1 = "0123456789ABCDEF0123"                  # both in the common list
KEY2 = "0123456789ABCDEF0123456789ABCDEF"


def _encrypted_capture(pkg: str, path: Path) -> None:
    """TEA1- then TEA2-encrypted SDS slots on one 2.4 Msps carrier,
    built with the package's own golden, modulator and TEADecryptor (as
    tests/integration/test_tools.py builds its capture)."""
    import importlib
    golden = importlib.import_module(f"{pkg}.ref.golden")
    modulator = importlib.import_module(f"{pkg}.ref.modulator")
    tea = importlib.import_module(f"{pkg}.crypto.tea")
    sources = importlib.import_module(f"{pkg}.runtime.sources")
    rng = np.random.default_rng(7)
    slots = []
    for key, alg, text in ((KEY1, "TEA1", b"\x82RELOCATE NOW"),
                           (KEY2, "TEA2", b"\x82GATE SEVEN OPEN")):
        clear = text + b"\x00" * ((-len(text)) % 8)
        cipher = tea.TEADecryptor(bytes.fromhex(key), alg).encrypt(clear)
        for _ in range(4):
            data = golden.build_mac_resource_data_bits(cipher, rng=rng,
                                                       enc_mode=1)
            slots.append(golden.build_slot(data, rng=rng))
    pad = rng.integers(0, 2, 64).astype(np.uint8)
    iq = modulator.generate_carrier(np.concatenate([pad] + slots), fs=2.4e6)
    sources.write_capture(path, modulator.add_awgn(iq, 25, rng))


def test_decrypt_capture_reports_equal(tmp_path):
    for pkg in ("tetraear_tpu", "tetraear_tpu_torch"):
        _encrypted_capture(pkg, tmp_path / f"{pkg}.cfile")
    assert (tmp_path / "tetraear_tpu.cfile").read_bytes() == \
        (tmp_path / "tetraear_tpu_torch.cfile").read_bytes()
    runs = _both("decrypt_capture", lambda pkg: [
        "--source", str(tmp_path / f"{pkg}.cfile")])
    (rc_w, want), (rc_g, got) = runs["tetraear_tpu"], \
        runs["tetraear_tpu_torch"]
    assert rc_w == rc_g == 0
    # every decrypted frame: its number, key, confidence and text
    assert got == want
    assert "RELOCATE NOW" in got and "GATE SEVEN OPEN" in got
    assert "key=TEA1" in got and "key=TEA2" in got


def test_decrypt_capture_searches_on_the_device_path(tmp_path, monkeypatch):
    """The port's decrypt-capture finishes a block's pending frames with
    one key search for both families, its plaintexts scored there
    (tea_decrypt_scored)."""
    from tetraear_tpu_torch.crypto import batch
    _encrypted_capture("tetraear_tpu_torch", tmp_path / "enc.cfile")
    calls = []
    real = batch.tea_decrypt_scored

    def counted(*a, **k):
        calls.append(k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(batch, "tea_decrypt_scored", counted)
    rc, out = _run("tetraear_tpu_torch", "decrypt_capture",
                   ["--source", str(tmp_path / "enc.cfile")])
    assert rc == 0 and "DECRYPTED" in out
    assert calls and all(str(d) == "cpu" for d in calls)


# -- auto-capture ---------------------------------------------------------

def _hit_files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob("hit_*"))}


@pytest.mark.parametrize("source", ["synthetic", "synthetic-voice"])
def test_auto_capture_finds_equal(tmp_path, source):
    runs = _both("auto_capture", lambda pkg: [
        "--source", source, "--max-blocks", "5",
        "-o", str(tmp_path / pkg)], tmp_path)
    assert runs["tetraear_tpu_torch"] == runs["tetraear_tpu"]
    assert runs["tetraear_tpu_torch"][0] == 0
    want = _hit_files(tmp_path / "tetraear_tpu")
    got = _hit_files(tmp_path / "tetraear_tpu_torch")
    assert got == want and got
    if source == "synthetic":
        hit = json.loads(got["hit_frame.json"])
        assert "HELLO" in (hit.get("sds_message") or "")
    else:
        assert "hit_voice.wav" in got


def test_auto_capture_gives_up_on_noise_in_both(tmp_path):
    from tetraear_tpu_torch.runtime.sources import write_capture
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal(300_000)
             + 1j * rng.standard_normal(300_000)).astype(np.complex64)
    path = tmp_path / "noise.cfile"
    write_capture(path, noise)
    runs = _both("auto_capture", lambda pkg: [
        "--source", str(path), "--max-blocks", "3",
        "-o", str(tmp_path / pkg)], tmp_path)
    assert runs["tetraear_tpu_torch"] == runs["tetraear_tpu"]
    assert runs["tetraear_tpu_torch"][0] == 1
    assert not _hit_files(tmp_path / "tetraear_tpu_torch")


# -- listen-clear ---------------------------------------------------------

def test_listen_clear_counts_equal(tmp_path):
    runs = _both("listen_clear", lambda pkg: [
        "--source", "synthetic-voice", "--max-blocks", "4",
        "-o", str(tmp_path / pkg)], tmp_path)

    def summary(out):
        return [line for line in out.splitlines()
                if not line.startswith("[+] call written")]

    (rc_w, want), (rc_g, got) = runs["tetraear_tpu"], \
        runs["tetraear_tpu_torch"]
    assert rc_w == rc_g == 0
    assert summary(got) == summary(want)
    assert " 0 voice frames" not in got.splitlines()[-1]
    # the calls' PCM (file names carry the wall clock)
    wavs = {pkg: [p.read_bytes() for p in sorted((tmp_path / pkg).glob(
        "*.wav"))] for pkg in runs}
    assert wavs["tetraear_tpu_torch"] == wavs["tetraear_tpu"]
    assert wavs["tetraear_tpu_torch"]


def test_chip_smoke_compares_listen_clear_apart_from_the_wall_clock(
        tmp_path):
    """chip_smoke.py holds the card's listen-clear stdout to the CPU
    run's; a call file's name carries the second the call started, which
    differs between the runs when a second boundary falls between them.
    Only that stamp is set aside: another talkgroup or count still
    differs."""
    import importlib.util
    import re
    import time
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tools", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.DEV = "cpu"
    out_dir = tmp_path / "calls"
    rc, out, _, _ = cs.tool_run("listen_clear", [
        "--source", "synthetic-voice", "--max-blocks", "4",
        "-o", str(out_dir)], "cpu", out_dir)
    assert rc == 0
    stamp = re.compile(r"(call_tg\d+_)(\d{8}_\d{6})(\.wav)")
    assert stamp.search(out), out

    def later(m):
        t = time.strptime(m.group(2), "%Y%m%d_%H%M%S")
        return (m.group(1) + time.strftime(
            "%Y%m%d_%H%M%S", time.localtime(time.mktime(t) + 1))
            + m.group(3))

    next_second = stamp.sub(later, out)
    assert next_second != out
    assert cs.wall_clock_names(next_second) == cs.wall_clock_names(out)
    assert "<start>" in cs.wall_clock_names(out)
    for other in (out.replace("call_tg0_", "call_tg7_"),
                  out.replace(" 1 calls", " 2 calls")):
        assert other != out
        assert cs.wall_clock_names(other) != cs.wall_clock_names(out)


# -- bruteforce-keys --------------------------------------------------------

BF_KEY1 = "C0DEC0DEC0DEC0DEC0DE"         # not in the common list
BF_KEY2 = "00112233445566778899AABBCCDDEEFF"
BF_TEXTS = ("MEET AT DEPOT", "Unit 12 en route", "GATE SEVEN OPEN",
            "all clear here")


@pytest.fixture(scope="module")
def bruteforce_inputs(tmp_path_factory):
    """A JSONL of 8 encrypted frames (TEA1 and TEA2 with keys outside the
    common list, and with common keys) among clear and broken lines, and
    the 228 common keys plus the two right ones."""
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.tools.generate_common_keys import generate
    d = tmp_path_factory.mktemp("bruteforce")
    rng = np.random.default_rng(12)
    rows = []
    plan = [(BF_KEY1, "TEA1"), (BF_KEY2, "TEA2"), (KEY1, "TEA1"),
            (KEY2, "TEA3")]
    for i in range(8):
        key, alg = plan[i % 4]
        text = b"\x82" + BF_TEXTS[i % 4].encode()
        clear = text + b"\x00" * ((-len(text)) % 8)
        cipher = TEADecryptor(bytes.fromhex(key), alg).encrypt(clear)
        rows.append(json.dumps({"encrypted": True, "number": i,
                                "mac_pdu": {"data": cipher.hex()}}))
        rows.append(json.dumps({"encrypted": False, "mac_pdu": {
            "data": rng.bytes(8).hex()}}))
    rows.insert(3, "{not json")
    frames = d / "frames.jsonl"
    frames.write_text("\n".join(rows) + "\n")
    keys = d / "keys.txt"
    keys.write_text("\n".join(["# common keys and the right ones",
                               *generate(), f"TEA1:7:{BF_KEY1}",
                               f"TEA2:7:{BF_KEY2}", "bogus", ""]))
    return frames, keys


def test_bruteforce_keys_candidates_equal_one_search(bruteforce_inputs,
                                                     monkeypatch):
    from tetraear_tpu_torch.crypto import batch
    frames, keys = bruteforce_inputs
    calls = []
    real = batch.tea_decrypt_families

    def counted(payloads, tea1_keys, tea2_keys, device=None):
        calls.append((len(tea1_keys), len(tea2_keys), payloads.shape))
        return real(payloads, tea1_keys, tea2_keys, device=device)

    monkeypatch.setattr(batch, "tea_decrypt_families", counted)
    argv = [str(frames), "-k", str(keys), "--top", "40"]
    runs = _both("bruteforce_keys", lambda pkg: argv)
    (rc_w, want), (rc_g, got) = runs["tetraear_tpu"], \
        runs["tetraear_tpu_torch"]
    assert rc_w == rc_g == 0
    # every candidate (key, frame, text, score) and the ranking, in order
    assert got == want
    cands = [line for line in got.splitlines()
             if line.startswith("[+] candidate")]
    assert len(cands) > 8
    # ONE key search for both cipher families
    assert len(calls) == 1
    k1, k2, shape = calls[0]
    assert k1 > 0 and k2 > 0 and shape[0] == 8
    # each transmitted text among the candidates, under its right key
    # (random plaintexts of wrong keys may outscore it: the reference's
    # plausibility score ranks printable latin-1 highly)
    for (key, alg), text in zip([(BF_KEY1, "TEA1"), (BF_KEY2, "TEA2"),
                                 (KEY1, "TEA1"), (KEY2, "TEA3")], BF_TEXTS):
        assert any(f"key={alg}:{key[:20]}..." in c and repr(text) in c
                   for c in cands), (alg, text)


def test_bruteforce_keys_no_encrypted_frames(tmp_path):
    frames = tmp_path / "clear.jsonl"
    frames.write_text(json.dumps({"encrypted": False}) + "\n")
    keys = tmp_path / "k.txt"
    keys.write_text(f"TEA1:0:{KEY1}\n")
    runs = _both("bruteforce_keys", lambda pkg: [str(frames), "-k",
                                                 str(keys)])
    assert runs["tetraear_tpu_torch"] == runs["tetraear_tpu"]
    assert runs["tetraear_tpu_torch"][0] == 1


def test_bruteforce_keys_score_and_key_file_equal(bruteforce_inputs):
    from tetraear_tpu.tools import bruteforce_keys as ref
    from tetraear_tpu_torch.tools import bruteforce_keys as port
    _, keys = bruteforce_inputs
    assert port.load_keys(keys) == ref.load_keys(keys)
    for text in ("", "abc", "Hello World", "\x00\x01ABCD", "ALL CAPS",
                 *BF_TEXTS):
        assert port.score_text(text) == ref.score_text(text)


# -- generate-keys, analyze-text ---------------------------------------------

def test_generate_keys_identical(tmp_path):
    runs = _both("generate_common_keys", lambda pkg: [])
    assert runs["tetraear_tpu_torch"] == runs["tetraear_tpu"]
    files = {}
    for pkg in ("tetraear_tpu", "tetraear_tpu_torch"):
        out = tmp_path / f"{pkg}.txt"
        assert _run(pkg, "generate_common_keys", ["-o", str(out)])[0] == 0
        files[pkg] = out.read_text()
    assert files["tetraear_tpu_torch"] == files["tetraear_tpu"]
    from tetraear_tpu_torch.tools.generate_common_keys import generate
    assert len(generate()) == 228


def test_analyze_text_identical(tmp_path):
    rng = np.random.default_rng(5)
    rows = []
    for i in range(30):
        kind = i % 3
        if kind == 0:
            rows.append({"sds_message": f"[TXT] UNIT {i} AT GATE"})
        elif kind == 1:
            rows.append({"decoded_text": "".join(
                chr(c) for c in rng.integers(32, 127, 12))})
        else:
            rows.append({"sds_message": None, "decoded_text": ""})
    log = tmp_path / "frames.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in rows)
                   + "\nnot json\n")
    for argv in ([str(log)], [str(log), "--top", "3", "--min-score",
                              "0.5"]):
        runs = _both("analyze_text", lambda pkg: argv)
        assert runs["tetraear_tpu_torch"] == runs["tetraear_tpu"]
        assert runs["tetraear_tpu_torch"][0] == 0


# -- verify-codec -----------------------------------------------------------

@pytest.mark.skipif(shutil.which("g++") is None
                    or shutil.which("make") is None,
                    reason="g++ and make build the port's codec")
def test_verify_codec_on_the_ports_codec():
    """--build builds tetraear_tpu_torch/voice/csrc (native.py); the
    checks print what the JAX tool prints on its own codec."""
    from tetraear_tpu_torch import native
    from tetraear_tpu.voice import codec as ref_codec
    rc, got = _run("tetraear_tpu_torch", "verify_codec", ["--build"])
    assert rc == 0, got
    assert native.build_info["voice"]["path"].startswith(
        str(REPO / "tetraear_tpu_torch" / "voice" / "csrc"))
    if ref_codec.VoiceProcessor().working:
        rc_w, want = _run("tetraear_tpu", "verify_codec", [])
        assert rc_w == 0 and got == want


# -- build-release ------------------------------------------------------------

def test_build_release_archive_holds_the_port(tmp_path, monkeypatch):
    from tetraear_tpu_torch import native
    from tetraear_tpu_torch.tools import build_release
    built = []
    monkeypatch.setattr(native, "build", lambda name: built.append(name))
    archive = build_release.build(tmp_path, with_codec=True)
    assert sorted(built) == ["frame", "voice"]
    assert archive.name.startswith("tetraear-tpu-torch-")
    with tarfile.open(archive) as tf:
        names = tf.getnames()
    root = archive.name.replace(".tar.gz", "")
    for rel in ("tetraear_tpu_torch/dsp/csrc/fft2p.cu",
                "tetraear_tpu_torch/dsp/csrc/common.cuh",
                "tetraear_tpu_torch/frame/csrc/hitparse.cpp",
                "tetraear_tpu_torch/voice/csrc/Makefile",
                "tetraear_tpu_torch/api.py", "chip_smoke.py",
                "pyproject.toml", "README.md", "pytest.ini"):
        assert f"{root}/{rel}" in names, rel
    assert not any("build" in Path(n).parts or n.endswith((".so", ".pyc"))
                   or "__pycache__" in n for n in names)
    assert not any(n.startswith(f"{root}/tetraear_tpu/") for n in names)
    assert not any(n.startswith(f"{root}/tests") for n in names)


# -- the CLI's tool dispatch --------------------------------------------------

@pytest.mark.parametrize("name,module", [
    ("listen-clear", "listen_clear"),
    ("continuous-capture", "continuous_capture"),
    ("decrypt-capture", "decrypt_capture"),
    ("bruteforce-keys", "bruteforce_keys"),
    ("generate-keys", "generate_common_keys"),
    ("analyze-text", "analyze_text"),
    ("verify-codec", "verify_codec"),
    ("auto-capture", "auto_capture"),
    ("build-release", "build_release"),
])
def test_cli_dispatches_each_tool(name, module, monkeypatch):
    """``tetraear_tpu_torch <tool> ARGS`` hands ARGS (options the CLI
    does not know included) to that tool's main, as the JAX CLI does."""
    from tetraear_tpu_torch import cli
    from tetraear_tpu import cli as ref_cli
    seen = []
    mod = _tool("tetraear_tpu_torch", module)
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv) or 7)
    argv = [name, "--device", "cpu", "-x", "pos"]
    assert cli.main(argv) == 7
    assert seen == [["--device", "cpu", "-x", "pos"]]
    assert (name, module) in cli.TOOLS
    # the same names as the JAX CLI's dispatch
    ref_mod = _tool("tetraear_tpu", module)
    monkeypatch.setattr(ref_mod, "main", lambda argv: seen.append(argv) or 7)
    assert ref_cli.main(argv) == 7


def test_cli_module_runs_a_tool(tmp_path):
    """``python -m tetraear_tpu_torch generate-keys`` in its own process
    prints the JAX tool's key list; no JAX module is loaded there."""
    code = ("import runpy, sys\n"
            "sys.argv = ['tetraear_tpu_torch', 'generate-keys']\n"
            "try:\n"
            "    runpy.run_module('tetraear_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tetraear_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                            "HOME": str(tmp_path)},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = _run("tetraear_tpu", "generate_common_keys", [])[1]
    assert r.stdout == want


def test_cli_rejects_unknown_options_of_its_own_commands(capsys):
    from tetraear_tpu_torch import cli
    with pytest.raises(SystemExit):
        cli.main(["decode", "--source", "x.cs16", "--bogus"])
    assert "unrecognized arguments: --bogus" in capsys.readouterr().err
