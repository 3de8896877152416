"""The port's own copies of the host modules, and its two import rules.

tetraear_tpu_torch imports nothing of tetraear_tpu: it keeps its own
copy of every host module it needs (frame layer, filter design, golden
transmitter, sources, TEA, logging).  A copy may lose comments and
docstrings but not drift in code: each case compares the syntax tree of
a copy with the original's after the package name is normalised and
docstrings are dropped, function by function, and lists the functions
that differ on purpose (places that reached JAX or a module that is not
ported yet).

Two guards besides: a subprocess imports every module of the port and
finds neither ``jax`` nor any ``tetraear_tpu`` module loaded; and on a
machine without a CUDA device the port's entry points raise instead of
running on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "tetraear_tpu"
PORT = REPO / "tetraear_tpu_torch"

# module -> qualified names whose code differs on purpose
COPIES = {
    "dsp/design.py": (),
    "frame/burst.py": (),
    "frame/crc.py": (),
    "frame/lip.py": (),
    "frame/sds.py": (),
    "frame/mac.py": (),
    "frame/decoder.py": (),
    "frame/aggregator.py": (),
    "frame/structure.py": (),
    "frame/validator.py": (),
    "frame/hitparse.py": (),
    "frame/location.py": (),
    "frame/mcc_mnc.py": (),
    "frame/sdsstore.py": (),
    "crypto/tea.py": (),
    "dsp/fm.py": (),
    "ref/modulator.py": (),
    "ref/polyphase.py": (),
    "utils/logging.py": (),
    "voice/etsi_tables.py": (),
    "voice/acelp_tables.py": (),
    "voice/codec.py": (),
    "voice/export.py": (),
    "ref/golden.py": (),
    "runtime/sources.py": (),
    "ref/demod.py": (),
    "scan/detector.py": (),
    # the wideband scan's carrier bank runs on the port's device
    "scan/scanner.py": ("WidebandScanner.scan",),
    # the scan kernel is built at first use on the port's device, the
    # native parser is built before the first parse, and the deferred
    # key search runs on that device; spans of the port's tracer
    "frame/batch.py": ("BatchedFrameDecoder.__init__",
                       "BatchedFrameDecoder.kernel",
                       "BatchedFrameDecoder._attach_and_decrypt",
                       "BatchedFrameDecoder.process_scanned_sparse",
                       "BatchedFrameDecoder.select_and_decode_hits"),
    # the parent's frame layer and its key search take the device; the
    # workers' MAC parser states travel in the port's checkpoints
    "frame/parallel.py": ("ShardedFrameLayer.__init__",
                          "ShardedFrameLayer._finish_block",
                          "_worker_main",
                          "ShardedFrameLayer.parser_states",
                          "ShardedFrameLayer.set_parser_states"),
    "utils/keyload.py": (),
    "utils/settings.py": (),
    "ref/legacy.py": (),
    "tools/__init__.py": (),
    "tools/generate_common_keys.py": (),
    "tools/analyze_text.py": (),
    # the tools take --device (the reference's have no such flag) and
    # raise without a card unless it says cpu; bruteforce-keys' search
    # is one launch for both cipher families (tea_decrypt_families),
    # its score_text / load_keys equal
    "tools/bruteforce_keys.py": ("main",),
    "tools/decrypt_capture.py": ("main",),
    "tools/continuous_capture.py": ("main",),
    "tools/listen_clear.py": ("main",),
    "tools/auto_capture.py": ("main",),
    # --build builds the port's voice/csrc through native.py
    "tools/verify_codec.py": ("main",),
    # the port's archive: its package and chip_smoke.py, no build/
    # directory or shared library, the port's two libraries built
    "tools/build_release.py": ("build", "<module statements>"),
    "ui/__init__.py": (),
    "ui/spectrum.py": (),
    "ui/filters.py": (),
    "ui/status.py": (),
    "ui/recording.py": (),
    # --device (default: the card) goes to PipelineConfig.device
    "ui/dashboard.py": ("main",),
    # the window keeps its device (raising without a card unless it is
    # "cpu"), hands it to the capture thread's PipelineConfig, and main
    # takes --device; the capture thread and the dialogs are unchanged
    "ui/qt.py": ("ModernTetraGUI.__init__", "ModernTetraGUI.on_start",
                 "main"),
}

# string literals the copies word otherwise (original -> copy)
REWORDED = {"USB driver issue:": "USB access problem:"}

# single definitions taken from larger modules
PARTS = {
    "PipelineStats": ("api.py", "api.py"),
    "_jsonable": ("api.py", "api.py"),
    "CLIListener": ("cli.py", "cli.py"),
    "Pipeline._detect_signal": ("api.py", "api.py"),
    "Pipeline.set_keys": ("api.py", "api.py"),
    "Pipeline._maybe_afc_retune": ("api.py", "api.py"),
    "Pipeline.run": ("api.py", "api.py"),
    "Pipeline.frames": ("api.py", "api.py"),
    "Pipeline.__del__": ("api.py", "api.py"),
    "Pipeline.voice_for": ("api.py", "api.py"),
    "Pipeline._is_voice_candidate": ("api.py", "api.py"),
    "Pipeline._synth_voice_parallel": ("api.py", "api.py"),
    "Pipeline._try_voice": ("api.py", "api.py"),
    "Pipeline._try_voice_stolen": ("api.py", "api.py"),
    "Pipeline._synth_voice_device": ("api.py", "api.py"),
    "Pipeline._synth_voice": ("api.py", "api.py"),
    # the device speech pool's slot management
    "DeviceSpeechPool._slot_for": ("voice/jspeech_pool.py",
                                   "voice/speech_pool.py"),
    "DeviceSpeechPool.synthesize": ("voice/jspeech_pool.py",
                                    "voice/speech_pool.py"),
    "_pow2_at_least": ("voice/jspeech_pool.py", "voice/speech_pool.py"),
    # the static maps of the speech channel decoder
    "_expected_signs": ("voice/jviterbi.py", "voice/viterbi.py"),
    "_code_step_index": ("voice/jviterbi.py", "voice/viterbi.py"),
    "_unbuild": ("voice/jviterbi.py", "voice/viterbi.py"),
    # the profiling module's host parts (the rest is the H100's roofline)
    "StageTimers": ("runtime/profiling.py", "runtime/profiling.py"),
    "roofline_estimate": ("runtime/profiling.py", "runtime/profiling.py"),
}


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _flatten(body):
    """Module-level statements with the bodies of module-level ``if``
    blocks spliced in, each ``if``'s test kept as a statement: the Qt
    window's classes are defined under ``if QT_AVAILABLE:``."""
    for node in body:
        if isinstance(node, ast.If):
            yield ast.Expr(node.test)
            yield from _flatten(node.body)
            yield from _flatten(node.orelse)
        else:
            yield node


def _definitions(path: Path) -> dict:
    """{qualified name: ast dump} of a module's top-level statements and
    its classes' methods (those under a module-level ``if`` too), package
    name normalised, docstrings dropped."""
    src = path.read_text().replace("tetraear_tpu_torch", "tetraear_tpu")
    for old, new in REWORDED.items():
        src = src.replace(old, new)
    tree = _strip_docstrings(ast.parse(src))
    out, other = {}, []
    for node in _flatten(tree.body):
        if isinstance(node, ast.ClassDef):
            rest = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = ast.dump(sub)
                else:
                    rest.append(ast.dump(sub))
            out[node.name] = repr((ast.dump(ast.Module(node.bases, [])),
                                   rest))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        else:
            other.append(ast.dump(node))
    out["<module statements>"] = repr(other)
    return out


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_equals_original(rel):
    want = _definitions(JAX_PKG / rel)
    got = _definitions(PORT / rel)
    differ = {name for name in set(want) | set(got)
              if want.get(name) != got.get(name)}
    assert differ == set(COPIES[rel]), (
        f"{rel}: differs in {sorted(differ)}, intended "
        f"{sorted(COPIES[rel])}")


@pytest.mark.parametrize("name", sorted(PARTS))
def test_part_equals_original(name):
    src_rel, dst_rel = PARTS[name]
    want = _definitions(JAX_PKG / src_rel)
    got = _definitions(PORT / dst_rel)
    keys = [k for k in want if k == name or k.startswith(name + ".")]
    assert keys
    for k in keys:
        assert got.get(k) == want[k], k


@pytest.mark.parametrize("rel", ["Makefile", "hitparse.cpp"])
def test_native_parser_sources_equal(rel):
    want = (JAX_PKG / "frame/csrc" / rel).read_text()
    got = (PORT / "frame/csrc" / rel).read_text()
    assert got.replace("tetraear_tpu_torch", "tetraear_tpu") == want


@pytest.mark.parametrize("rel", sorted(
    p.name for p in (JAX_PKG / "voice/csrc").iterdir() if p.is_file()))
def test_codec_sources_equal(rel):
    want = (JAX_PKG / "voice/csrc" / rel).read_text()
    got = (PORT / "voice/csrc" / rel).read_text()
    assert got.replace("tetraear_tpu_torch", "tetraear_tpu") == want


def test_port_imports_nothing_of_the_jax_package(tmp_path):
    """Every module of the port imports, and neither jax nor any module
    named tetraear_tpu or tetraear_tpu.* is loaded afterwards."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tetraear_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " 'tetraear_tpu_torch.')]\n"
        "for n in names:\n"
        "    if not n.endswith('__main__'):\n"
        "        importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'jaxlib'"
        " or m == 'tetraear_tpu' or m.startswith('tetraear_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "new = {'tetraear_tpu_torch.runtime.sharding',"
        " 'tetraear_tpu_torch.runtime.distributed',"
        " 'tetraear_tpu_torch.runtime.multichip',"
        " 'tetraear_tpu_torch.ref.demod',"
        " 'tetraear_tpu_torch.scan.detector',"
        " 'tetraear_tpu_torch.scan.scanner',"
        " 'tetraear_tpu_torch.runtime.profiling',"
        " 'tetraear_tpu_torch.utils.keyload',"
        " 'tetraear_tpu_torch.utils.settings',"
        " 'tetraear_tpu_torch.ref.legacy',"
        " 'tetraear_tpu_torch.tools.bruteforce_keys',"
        " 'tetraear_tpu_torch.tools.decrypt_capture',"
        " 'tetraear_tpu_torch.tools.continuous_capture',"
        " 'tetraear_tpu_torch.tools.listen_clear',"
        " 'tetraear_tpu_torch.tools.auto_capture',"
        " 'tetraear_tpu_torch.tools.verify_codec',"
        " 'tetraear_tpu_torch.tools.build_release',"
        " 'tetraear_tpu_torch.tools.generate_common_keys',"
        " 'tetraear_tpu_torch.tools.analyze_text',"
        " 'tetraear_tpu_torch.ui.spectrum', 'tetraear_tpu_torch.ui.filters',"
        " 'tetraear_tpu_torch.ui.status', 'tetraear_tpu_torch.ui.recording',"
        " 'tetraear_tpu_torch.ui.dashboard', 'tetraear_tpu_torch.ui.qt',"
        " 'tetraear_tpu_torch.examples.decode_capture',"
        " 'tetraear_tpu_torch.examples.offair_fixture',"
        " 'tetraear_tpu_torch.examples.dense_fleet',"
        " 'tetraear_tpu_torch.examples.wideband_scan',"
        " 'tetraear_tpu_torch.examples.voice_roundtrip',"
        " 'tetraear_tpu_torch.examples.sharded_deployment',"
        " 'tetraear_tpu_torch.bench'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "print('CLEAN', len(names))\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout


def test_source_names_the_jax_package_only_in_prose():
    """No import statement of the port or of chip_smoke.py names the JAX
    package (docstrings and comments may point a reader to it)."""
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "tetraear_tpu"), (
                    path, n)


# -- the card by default ----------------------------------------------------

def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")


def test_resolve_cpu_only_when_asked():
    from tetraear_tpu_torch.device import resolve
    assert resolve("cpu").type == "cpu"
    _no_card()
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        resolve(None)
    with pytest.raises(RuntimeError):
        resolve("cuda")


@pytest.mark.parametrize("entry", ["pipeline", "fused", "runner",
                                   "bank_state", "scan_kernel", "convert",
                                   "cli", "listen", "key_search",
                                   "sharded", "voice_decode",
                                   "speech_pool", "speech_state",
                                   "mesh", "multichip", "wideband_scan",
                                   "scan_cli", "bruteforce_keys",
                                   "decrypt_capture", "continuous_capture",
                                   "listen_clear", "auto_capture",
                                   "profiler", "measure_hbm",
                                   "measured_hbm", "tool_cli",
                                   "dashboard", "qt_gui",
                                   "example_decode_capture", "bench",
                                   "bench_cli"])
def test_entry_points_raise_without_a_card(entry, tmp_path, monkeypatch):
    """No device given means the card: on a machine without one every
    entry point raises; none carries on on the CPU."""
    _no_card()
    from tetraear_tpu_torch import convert
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.cli import main
    from tetraear_tpu_torch.crypto.batch import tea_key_search
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.framescan import FrameScanKernel
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
    from tetraear_tpu_torch.runtime.multichip import dryrun_multichip
    from tetraear_tpu_torch.runtime.sharding import make_mesh
    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    from tetraear_tpu_torch.scan.scanner import WidebandScanner
    from tetraear_tpu_torch.voice.speech import init_state
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool
    from tetraear_tpu_torch.voice.viterbi import channel_decode_batch
    from tetraear_tpu_torch.runtime import profiling
    from tetraear_tpu_torch import tools
    import importlib

    import numpy as np
    monkeypatch.delenv("TETRAEAR_MEASURED_GBS", raising=False)
    out = str(tmp_path / "out")

    def qt_gui():
        # the window over the PyQt6 stub, imported afresh (sys.modules
        # restored by monkeypatch)
        for name in ("PyQt6", "PyQt6.QtCore", "PyQt6.QtGui",
                     "PyQt6.QtWidgets", "tetraear_tpu_torch.ui.qt"):
            monkeypatch.setitem(sys.modules, name, None)
            del sys.modules[name]
        monkeypatch.syspath_prepend(str(REPO))
        monkeypatch.setenv("TETRAEAR_TPU_DATA_DIR", str(tmp_path))
        from tests.unit import qt_stub
        qt_stub.install()
        qt = importlib.import_module("tetraear_tpu_torch.ui.qt")
        assert qt.QT_AVAILABLE
        qt.ModernTetraGUI().on_start()

    def tool(name, *argv):
        return lambda: importlib.import_module(
            f"{tools.__name__}.{name}").main(list(argv))
    calls = {
        "pipeline": lambda: Pipeline(PipelineConfig()),
        "fused": lambda: FusedRx(CarrierBankDemod(
            fs=2.304e6, freqs_hz=[12_500.0], frontend="fft")),
        "runner": lambda: DecodeRunner(
            CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0]),
            BatchedFrameDecoder(1)),
        "bank_state": lambda: CarrierBankDemod(
            fs=2.4e6, freqs_hz=[0.0]).init_state(),
        "scan_kernel": lambda: FrameScanKernel(even_only=True),
        "convert": lambda: convert.state_from_jax(
            {"prev_sym": np.zeros((1, 2), np.float32)}),
        "cli": lambda: main(["decode", "--source",
                             str(REPO / "tests/fixtures/"
                                 "offair_2carrier.cs16")]),
        "listen": lambda: main(["listen", "--source", "synthetic",
                                "--max-blocks", "1"]),
        "key_search": lambda: tea_key_search(np.zeros((2, 8), np.uint8),
                                             [bytes(10)]),
        "sharded": lambda: Pipeline(PipelineConfig(frame_workers=2)),
        "voice_decode": lambda: channel_decode_batch(
            np.zeros((2, 432), np.int32)),
        "speech_pool": lambda: DeviceSpeechPool(slots=4),
        "speech_state": lambda: init_state(4),
        "mesh": lambda: make_mesh(1, 1),
        "multichip": lambda: dryrun_multichip(1),
        "wideband_scan": lambda: WidebandScanner().scan(
            np.zeros(300_000, np.complex64)),
        "scan_cli": lambda: main(["scan", "--wideband", "--source",
                                  "synthetic", "--dwell", "0.1"]),
        "bruteforce_keys": tool("bruteforce_keys", str(tmp_path / "f.jsonl"),
                                "-k", str(tmp_path / "k.txt")),
        "decrypt_capture": tool("decrypt_capture", "--max-blocks", "1"),
        "continuous_capture": tool("continuous_capture", "--max-blocks",
                                   "1", "-o", out),
        "listen_clear": tool("listen_clear", "--max-blocks", "1", "-o", out),
        "auto_capture": tool("auto_capture", "--source", "synthetic",
                             "--max-blocks", "1", "-o", out),
        "profiler": lambda: profiling.Profiler(tmp_path),
        "measure_hbm": lambda: profiling.measure_hbm_gbs(mb=1, steps=1),
        "measured_hbm": lambda: profiling.measured_hbm_gbs(tmp_path, mb=1),
        "tool_cli": lambda: main(["continuous-capture", "--max-blocks", "1",
                                  "-o", out]),
        "dashboard": lambda: importlib.import_module(
            "tetraear_tpu_torch.ui.dashboard").main(["--max-blocks", "1"]),
        "qt_gui": qt_gui,
        "example_decode_capture": lambda: importlib.import_module(
            "tetraear_tpu_torch.examples.decode_capture").main([]),
        "bench": lambda: importlib.import_module(
            "tetraear_tpu_torch.bench").run_bench(8, steps=1),
        "bench_cli": lambda: main(["bench"]),
    }
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        calls[entry]()


# -- the speech kernel's tables -----------------------------------------------

def test_speech_kernel_tables_and_bits2prm_walk():
    """V2's constant table (dsp/csrc/speech.cuh c_tab, filled from
    voice/speech.py _K_TAB): the kOff* offsets the kernel declares equal
    the host's layout, each table read back at the kernel's offsets is
    acelp_tables.py's, and the kernel's Bits2prm walk (parameter widths
    from c_tab, v = (v << 1) | (bit & 1) MSB first) in numpy equals the
    JAX package's bits2prm matrix on frames with high bits set."""
    import numpy as np
    from tetraear_tpu.voice import jspeech
    from tetraear_tpu_torch.voice import acelp_tables as T
    from tetraear_tpu_torch.voice import speech

    import re
    cuh = (PORT / "dsp/csrc/speech.cuh").read_text()
    offs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int kOff(\w+) = (\d+);", cuh)}
    n = int(re.search(r"constexpr int kTabLen = (\d+);", cuh).group(1))
    assert offs == speech.K_OFFSETS
    tab = speech._K_TAB
    assert tab.dtype == np.int16 and tab.size == n
    want = {"Dico1": T.DICO1_CLSP, "Dico2": T.DICO2_CLSP,
            "Dico3": T.DICO3_CLSP, "QuaEner": T.T_QUA_ENER,
            "Coef1": T.COEF1, "Coef2": T.COEF2, "Log2": T.TAB_LOG2,
            "Pow2": T.TAB_POW2, "LspoldInit": T.LSPOLD_INIT,
            "Bitno": T.BITNO}
    assert sorted(want) == sorted(offs)
    for name, arr in want.items():
        flat = np.asarray(arr).reshape(-1)
        np.testing.assert_array_equal(
            tab[offs[name]:offs[name] + flat.size], flat, err_msg=name)
    # D_Lsp334's reads: DICO1[3 i + k], DICO2[3 i + k], DICO3[4 i + k]
    for name, width in (("Dico1", 3), ("Dico2", 3), ("Dico3", 4)):
        rows = np.asarray(want[name])
        i = np.arange(rows.shape[0])
        for k in range(width):
            np.testing.assert_array_equal(
                tab[offs[name] + width * i + k], rows[:, k])
    # Ener_Update's reads: T_QUA_ENER[2 index], [2 index + 1]
    q = np.asarray(T.T_QUA_ENER)
    i = np.arange(q.shape[0])
    np.testing.assert_array_equal(tab[offs["QuaEner"] + 2 * i], q[:, 0])
    np.testing.assert_array_equal(tab[offs["QuaEner"] + 2 * i + 1], q[:, 1])

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 2, (64, 138)).astype(np.int32)
    frames[:, 1:] |= rng.integers(0, 8, (64, 137)).astype(np.int32) << 1
    frames[:, 0] = rng.integers(0, 3, 64)
    got = np.zeros((64, 24), np.int64)
    for r, bits in enumerate(frames):
        got[r, 0] = bits[0] != 0
        b = 1
        for i in range(23):
            v = 0
            for _ in range(int(tab[offs["Bitno"] + i])):
                v = (v << 1) | (int(bits[b]) & 1)
                b += 1
            got[r, 1 + i] = v
        assert b == 138
    want_prm = (frames[:, 1:] & 1) @ jspeech._B2P
    np.testing.assert_array_equal(got[:, 1:], want_prm)
    np.testing.assert_array_equal(got[:, 0], frames[:, 0] != 0)
