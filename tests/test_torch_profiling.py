"""The port's runtime/profiling.py: the H100 form of the JAX package's.

StageTimers and roofline_estimate are the JAX package's code (held by
tests/test_torch_hostcopies.py) and give its numbers on the same calls.
The roofline takes the card's peaks (one definition, shared with
chip_smoke.py's bound), the env overrides stay, and the measured HBM
rate comes from the environment, the port's own per-card record or a
fresh measurement on the card, never from the JAX package's TPU bundles
or its fallback figure.  The Profiler writes a Chrome trace.
"""

import builtins
import importlib.util
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu.runtime import profiling as ref  # noqa: E402
from tetraear_tpu_torch.runtime import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
ENV = ("TETRAEAR_MEASURED_GBS", "TETRAEAR_PEAK_TFLOPS", "TETRAEAR_PEAK_GBS",
       "TETRAEAR_ACELP_BASICOPS", "TETRAEAR_VOICE_EFF_OPS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")


# -- the JAX package's numbers ------------------------------------------------

def test_stage_timers_equal(monkeypatch):
    reports = []
    for mod in (ref, profiling):
        ticks = iter(range(0, 10_000, 7))          # the same clock each
        monkeypatch.setattr(time, "perf_counter",
                            lambda ticks=ticks: next(ticks) * 1e-3)
        t = mod.StageTimers()
        for i in range(5):
            with t.stage("front", items=1000 * i):
                pass
            with t.stage("scan"):
                pass
        with pytest.raises(ValueError):
            with t.stage("front", items=3):
                raise ValueError
        reports.append(t.report())
    assert reports[1] == reports[0]
    assert reports[1]["front"]["calls"] == 6
    assert "items_per_s" not in reports[1]["scan"]


@pytest.mark.parametrize("c,fs,frontend,decim", [
    (1024, 36.864e6, "fft", None), (10240, 294.912e6, "fft", 4096),
    (2, 2.4e6, "conv", None), (8, 2.304e6, "fft", 24), (1, 1e3, "conv", 1)])
def test_roofline_estimate_equal(c, fs, frontend, decim):
    assert profiling.roofline_estimate(c, fs, frontend, decim) == \
        ref.roofline_estimate(c, fs, frontend, decim)


# -- the H100 roofline --------------------------------------------------------

def test_roofline_fraction_defaults_to_h100_peaks(monkeypatch):
    monkeypatch.setenv("TETRAEAR_MEASURED_GBS", "3000")
    assert profiling.FP32_OPS_PER_S == 67e12
    assert profiling.HBM_BYTES_PER_S == 3.35e12
    got = profiling.roofline_fraction(1024, 36.864e6, 25.0)
    # the JAX package's function given the H100's peaks
    want = ref.roofline_fraction(1024, 36.864e6, 25.0, peak_flops=67e12,
                                 peak_bw=3.35e12)
    assert got == want
    # and not its own (TPU) defaults
    assert got != ref.roofline_fraction(1024, 36.864e6, 25.0)
    est = profiling.roofline_estimate(1024, 36.864e6)
    assert got["roofline_pct"] == pytest.approx(100 * max(
        25 * est["flops_per_s"] / 67e12,
        25 * est["hbm_bytes_per_s"] / 3.35e12))
    assert got["roofline_measured_pct"] == pytest.approx(100 * max(
        25 * est["flops_per_s"] / 67e12,
        25 * est["hbm_bytes_per_s"] / 3000e9))
    assert got["measured_gbs_source"] == "env:TETRAEAR_MEASURED_GBS"
    assert got["bound"] in ("compute", "memory")


def test_roofline_fraction_env_overrides(monkeypatch):
    monkeypatch.setenv("TETRAEAR_MEASURED_GBS", "2500")
    monkeypatch.setenv("TETRAEAR_PEAK_TFLOPS", "40")
    monkeypatch.setenv("TETRAEAR_PEAK_GBS", "2000")
    for c, fs, rt, fe in ((1024, 36.864e6, 3.0, "fft"),
                          (2, 2.4e6, 40.0, "conv")):
        for scan in (True, False):
            got = profiling.roofline_fraction(c, fs, rt, fe,
                                              include_scan=scan)
            assert got == ref.roofline_fraction(c, fs, rt, fe,
                                                include_scan=scan)
    got = profiling.roofline_fraction(1024, 36.864e6, 3.0, peak_flops=1e12,
                                      peak_bw=1e9)
    assert got == ref.roofline_fraction(1024, 36.864e6, 3.0,
                                        peak_flops=1e12, peak_bw=1e9)


# -- the measured HBM rate ----------------------------------------------------

def _tpu_bundle(root: Path) -> None:
    """A JAX-package PERF bundle whose hbm rung the reference would read."""
    (root / "PERF_fake.json").write_text(json.dumps({
        "started_utc": "2099-01-01T00:00:00Z",
        "steps": {"hbm": {"returncode": 0,
                          "result": {"axpy_gbs": 123.4, "mb": 1024}}}}))


def test_measured_hbm_gbs_env_first(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "card_key", lambda: CARD)
    profiling.record_hbm_gbs(2900.0, 1024, 16, CARD, tmp_path)
    monkeypatch.setenv("TETRAEAR_MEASURED_GBS", "3100.5")
    assert profiling.measured_hbm_gbs(tmp_path) == (
        3100.5, "env:TETRAEAR_MEASURED_GBS")


def test_measured_hbm_gbs_reads_the_cards_record(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "card_key", lambda: CARD)
    path = profiling.record_hbm_gbs(2912.25, 1024, 16, CARD, tmp_path)
    profiling.record_hbm_gbs(1000.0, 1024, 16, "another card, 350 W",
                             tmp_path)
    assert path == tmp_path / "build" / "tetraear_tpu_torch" / \
        profiling.HBM_FILE
    gbs, src = profiling.measured_hbm_gbs(tmp_path)
    assert gbs == 2912.25
    assert CARD in src and "1024 MiB" in src
    # the other card's record is its own
    monkeypatch.setattr(profiling, "card_key",
                        lambda: "another card, 350 W")
    assert profiling.measured_hbm_gbs(tmp_path)[0] == 1000.0


def test_measured_hbm_gbs_never_reads_a_tpu_bundle(tmp_path, monkeypatch):
    """A fake TPU bundle the reference would take is ignored: with no
    record for this card (and one under 1 GiB that does not count) the
    port measures on the card, and without one it raises; no PERF_*.json
    is opened and the reference's fallback figure never comes back."""
    _tpu_bundle(tmp_path)
    assert ref.measured_hbm_gbs(tmp_path) == (
        123.4, "PERF_fake.json:steps.hbm.axpy_gbs")
    ref_fallback = ref.measured_hbm_gbs(tmp_path / "empty")
    monkeypatch.setattr(profiling, "card_key", lambda: CARD)
    profiling.record_hbm_gbs(50.0, 512, 16, CARD, tmp_path)
    opened = []
    real_open = builtins.open

    def spy(file, *a, **k):
        opened.append(str(file))
        return real_open(file, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    real_read = Path.read_text
    monkeypatch.setattr(Path, "read_text", lambda self, *a, **k: (
        opened.append(str(self)), real_read(self, *a, **k))[1])
    gbs, src = profiling.measured_hbm_gbs(tmp_path, device="cpu", mb=1)
    assert gbs > 0 and src == "measured now:cpu (1 MiB)"
    assert gbs not in (123.4, 50.0, ref_fallback[0])
    assert not any(Path(p).name.startswith("PERF_") for p in opened)
    # a CPU measurement is not recorded as the card's
    assert json.loads(real_read(tmp_path / "build" / "tetraear_tpu_torch"
                                / profiling.HBM_FILE))[CARD]["gbs"] == 50.0
    _no_card()
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        profiling.measured_hbm_gbs(tmp_path)
    assert not any(Path(p).name.startswith("PERF_") for p in opened)


def test_measure_hbm_gbs_small_on_the_cpu():
    gbs = profiling.measure_hbm_gbs("cpu", mb=2, steps=3)
    assert isinstance(gbs, float) and gbs > 0
    _no_card()
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        profiling.measure_hbm_gbs(mb=1, steps=1)


def test_card_key_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert profiling.card_key() is None


# -- the Profiler -------------------------------------------------------------

def test_profiler_writes_a_chrome_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.float32)
    with profiling.Profiler(tmp_path / "traces", device="cpu") as prof:
        y = torch.fft.fft(x * 2.0)
    assert y.shape == x.shape
    path = prof.trace_path
    assert path.parent == tmp_path / "traces" and path.exists()
    trace = json.loads(path.read_text())
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("fft" in n for n in names) and any("mul" in n for n in names)
    assert prof.kernel_events() == []          # no card, no device events
    # a second trace does not overwrite the first
    with profiling.Profiler(tmp_path / "traces", device="cpu") as prof2:
        torch.ones(3).sum()
    assert prof2.trace_path != path and path.exists()


def test_profiler_needs_the_card_by_default():
    _no_card()
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        profiling.Profiler()


# -- voice_roofline -----------------------------------------------------------

def test_voice_roofline_defaults_are_the_ports_measured_figures():
    got = profiling.voice_roofline(1024, 0.1129, rt_factor=0.5)
    assert got["basicops_per_frame"] == 19_096
    assert got["eff_basicops_per_s"] == 1.26e11
    assert got["theoretical_int_issue_per_s"] == 132 * 128.0 * 1.98e9
    # the measurement the default rests on: 18,618,231 basic operations
    # in a launch of 0.146-0.148 ms
    assert 18_618_231 / 0.148e-3 < got["eff_basicops_per_s"] \
        < 18_618_231 / 0.146e-3
    # the JAX package's model given the same figures
    want = ref.voice_roofline(1024, 0.1129, rt_factor=0.5,
                              basicops_per_frame=19_096,
                              eff_ops_per_s=1.26e11)
    for k in ("model_voice_carriers_rt", "model_ms_per_block",
              "frames_per_carrier_block", "voice_model_pct"):
        assert got[k] == want[k], k
    assert not any("vpu" in k for k in got)


def test_voice_roofline_env_and_arguments(monkeypatch):
    monkeypatch.setenv("TETRAEAR_ACELP_BASICOPS", "20000")
    monkeypatch.setenv("TETRAEAR_VOICE_EFF_OPS", "2e11")
    got = profiling.voice_roofline(16, 0.1, frames_per_carrier_block=8)
    assert got["basicops_per_frame"] == 20000.0
    assert got["eff_basicops_per_s"] == 2e11
    assert got["model_voice_carriers_rt"] == pytest.approx(
        2e11 * 0.1 / (8 * 20000))
    assert "voice_model_pct" not in got
    got = profiling.voice_roofline(16, 0.1, basicops_per_frame=1e4,
                                   eff_ops_per_s=1e10)
    assert got["eff_basicops_per_s"] == 1e10
    assert got["basicops_per_frame"] == 1e4


# -- one definition of the card's peaks ---------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_profiling", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bound_reads_the_modules_peaks():
    cs = _chip_smoke()
    names = ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "N_SMS",
             "LOGIC_PER_CLK_SM", "QUARTER_PER_CLK_SM", "ISSUE_PER_CLK_SM",
             "SM_CLOCK_HZ")
    for name in names:
        assert getattr(cs, name) == getattr(profiling, name), name
    src = (REPO / "chip_smoke.py").read_text()
    for name in names:
        assert f"\n{name} = " not in src, f"chip_smoke.py defines {name}"
    per_ms = profiling.N_SMS * profiling.SM_CLOCK_HZ * 1e-3
    for io_bytes, ops, logic, quarter, issue in (
            (10 ** 9, 0.0, 0.0, 0.0, 0.0), (1000, 1e12, 0.0, 0.0, 0.0),
            (1000, 0.0, 1e10, 1e9, 0.0), (8, 0.0, 0.0, 0.0, 3e10)):
        r = cs.bound(io_bytes, ops, logic, quarter, issue)
        t_bytes = io_bytes / profiling.HBM_BYTES_PER_S * 1e3
        t_ops = max(ops / profiling.FP32_OPS_PER_S * 1e3,
                    logic / (profiling.LOGIC_PER_CLK_SM * per_ms),
                    quarter / (profiling.QUARTER_PER_CLK_SM * per_ms),
                    issue / (profiling.ISSUE_PER_CLK_SM * per_ms))
        assert r["bound_ms"] == max(t_bytes, t_ops)
        assert r["bound_by"] == ("bytes" if t_bytes >= t_ops
                                 else "operations")
