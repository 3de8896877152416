"""The port's receive slice end to end vs the JAX reference.

The JAX ``DecodeRunner`` on its fused path (TETRAEAR_FORCE_FUSED=1, the
Pallas kernels in interpret mode, as tests/unit/test_stream_runner.py
runs it) and the port's ``DecodeRunner`` / ``Pipeline.run_offline``
(plain versions on the CPU) decode the same golden captures; the
CRC-passing frames must be identical.  A subprocess checks that the
port's CLI decodes without importing JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.frame import batch as jax_batch  # noqa: E402
from tetraear_tpu.ref import golden  # noqa: E402
from tetraear_tpu.runtime.stream import DecodeRunner as JaxRunner  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder  # noqa: E402
from tetraear_tpu_torch.golden import ArraySource, fleet_capture  # noqa: E402
from tetraear_tpu_torch.runtime.stream import DecodeRunner  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FS = 2.304e6
ONE = [12_500.0]
EIGHT = [(i - 4) * 25_000 + 12_500.0 for i in range(8)]


def crc_frames(frames):
    return [(f["carrier"], f["stream_symbol"], f["burst_crc"],
             f.get("sds_message")) for f in frames if f["burst_crc"]]


def single_capture():
    """test_stream_runner.py's fused capture (24 SDS slots), zero-padded
    to whole blocks as Pipeline.run_offline pads a partial last block."""
    payloads = [golden.sds_text_payload("FUSED BACKHALF RUN")] * 24
    iq = golden.golden_iq(payloads, fs=FS, freq_offset_hz=ONE[0],
                          snr_db=25, seed=57)
    bl = CarrierBankDemod(fs=FS, freqs_hz=ONE, frontend="fft").block_len
    return np.concatenate([iq, np.zeros(-len(iq) % bl, np.complex64)])


def eight_capture():
    bl = CarrierBankDemod(fs=FS, freqs_hz=EIGHT,
                          frontend="fft").block_len
    return fleet_capture(FS, EIGHT, range(8), 2 * bl, seed=21, text="OCTO")


def jax_frames(iq, offsets):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TETRAEAR_FORCE_FUSED", "1")
        mp.setenv("TETRAEAR_NO_FUSED", "0")
        bank = JaxBank(fs=FS, freqs_hz=offsets, frontend="fft")
        batch = jax_batch.BatchedFrameDecoder(len(offsets),
                                              auto_decrypt=False)
        runner = JaxRunner(bank, batch, blocks_per_dispatch=2)
        assert runner.fused is not None
        return crc_frames(runner.run(iq)["frames"])


@pytest.fixture(scope="module")
def single():
    iq = single_capture()
    return iq, jax_frames(iq, ONE)


@pytest.fixture(scope="module")
def eight():
    iq = eight_capture()
    return iq, jax_frames(iq, EIGHT)


def port_runner_frames(iq, offsets, s=2):
    bank = CarrierBankDemod(fs=FS, freqs_hz=offsets, frontend="fft")
    runner = DecodeRunner(bank, BatchedFrameDecoder(
        len(offsets), auto_decrypt=False, device="cpu"),
        blocks_per_dispatch=s, device="cpu")
    assert runner.fused is not None
    out = runner.run(iq)
    assert runner.dispatches == -(-(len(iq) // bank.block_len) // s)
    return crc_frames(out["frames"])


def port_pipeline_frames(iq, offsets):
    got = []
    pipe = Pipeline(PipelineConfig(sample_rate=FS,
                                   carrier_offsets_hz=tuple(offsets),
                                   frontend="fft", carrier_afc=False,
                                   auto_decrypt=False, validate=False,
                                   device="cpu"), on_frame=got.append)
    assert pipe.runner.fused is not None
    stats = pipe.run_offline(ArraySource(iq, FS), blocks_per_dispatch=2)
    assert stats.crc_pass == len(crc_frames(got))
    return crc_frames(got)


def test_decode_runner_matches_jax(single):
    iq, want = single
    assert len(want) >= 4
    assert port_runner_frames(iq, ONE) == want


def test_pipeline_run_offline_matches_jax(single):
    iq, want = single
    got = port_pipeline_frames(iq, ONE)
    assert got == want
    assert all(m == "[TXT] FUSED BACKHALF RUN" for *_, m in got)


def test_pipeline_eight_carriers_matches_jax(eight):
    iq, want = eight
    got = port_pipeline_frames(iq, EIGHT)
    assert got == want
    texts = {(c, m) for c, _, _, m in got}
    assert {(c, f"[TXT] OCTO {c}") for c in range(8)} <= texts


@pytest.mark.parametrize("s", [1, 3])
def test_decode_runner_batch_size_invariant(single, s):
    """Frames do not depend on how many blocks a batch holds."""
    iq, want = single
    assert port_runner_frames(iq, ONE, s) == want


@pytest.mark.parametrize("change", [
    {"device_voice": True}, {"frame_workers": 2}, {"sparse_hits": False},
    {"carrier_afc": True}, {"sample_rate": 2.4e6},
    {"frontend": "conv"}])
def test_ineligible_config_raises(change):
    """Speech synthesis on the device builds the decoder-slot pool on the
    pipeline's device beside the same fused runner; frame workers build
    the worker-sharded frame layer under the same runner; what the fused
    back half cannot serve takes the classic chain, for the reason the
    JAX FusedRx gives."""
    cfg = dict(sample_rate=FS, carrier_offsets_hz=(12_500.0,),
               frontend="fft", carrier_afc=False, device="cpu")
    cfg.update(change)
    pipe = Pipeline(PipelineConfig(**cfg))
    if "device_voice" in change:
        from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool
        try:
            assert isinstance(pipe._voice_device, DeviceSpeechPool)
            assert pipe._voice_device.device.type == "cpu"
            assert pipe.runner.fused is not None
        finally:
            pipe.close()
        return
    if "frame_workers" in change:
        from tetraear_tpu_torch.frame.parallel import ShardedFrameLayer
        try:
            assert isinstance(pipe.batch, ShardedFrameLayer)
            assert pipe.batch.n_workers == 2 and pipe.decoders == []
            assert pipe.runner.batch is pipe.batch
            assert pipe.runner.fused is not None
            assert all(p.is_alive() for p in pipe.batch._procs)
        finally:
            pipe.close()
        assert pipe.batch._procs == []
        return
    if "sparse_hits" in change:
        assert pipe.runner.fused is not None and not pipe.runner.sparse
        return
    assert pipe.runner.fused is None
    if "carrier_afc" in change or "sample_rate" in change:
        # the same message as the JAX FusedRx
        with pytest.raises(ValueError) as ref:
            jax_backhalf.FusedRx(JaxBank(
                fs=cfg["sample_rate"], freqs_hz=[12_500.0], frontend="fft",
                afc=cfg.get("carrier_afc", False)))
        assert pipe.runner._backhalf_reason == str(ref.value)


def test_cli_decode_imports_no_jax(tmp_path):
    """The port's CLI decodes a capture file on the CPU, and neither jax
    nor any module of the JAX package is in sys.modules afterwards."""
    path = tmp_path / "capture.npy"
    np.save(path, single_capture())
    code = (
        "import sys\n"
        "from tetraear_tpu_torch.cli import main\n"
        f"rc = main(['decode', '--source', {str(path)!r}, '-s', '2.304',"
        " '--offsets', '12500', '--dispatch-blocks', '2', '--frontend',"
        " 'fft', '--no-carrier-afc', '--device', 'cpu'])\n"
        "assert rc == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'tetraear_tpu'"
        " or m.startswith('tetraear_tpu.'))\n"
        "assert not bad, bad\n"
        "print('JAX_FREE')\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_FREE" in r.stdout
    summary = json.loads(r.stdout[r.stdout.index("{\n"):
                                  r.stdout.rindex("\n}") + 2])
    assert summary["crc_pass"] >= 4 and summary["device"] == "cpu"
    assert summary["backhalf"] == "fused"
