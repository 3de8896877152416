"""The port's voice chain against the JAX package's, on the CPU.

The cases of tests/codec/test_voice_rf.py carried over: speech PCM ->
ACELP + channel encode -> golden traffic slots -> IQ at 2.4 Msps, then
the port's ``Pipeline(voice=True, device="cpu")`` and the JAX
``Pipeline(voice=True)`` on the same capture.  They must give the same
PCM chunks sample for sample (the float32 audio is int16 / 32768, so
equality is exact int16 equality) and the same ``voice_frames`` /
``stolen_frames``: with frame stealing, with ``voice_threads`` 2
against 0, with the lazy soft view (sparse hits) against the dense
planes, on the worker-sharded frame layer, through ``process_block`` and
``run_offline``.  A checkpoint
split mid-call gives the unsplit PCM, and a checkpoint the JAX package
writes (its host speech decoder states, aux ``vhost``) restores into
the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu.api import Pipeline as JaxPipeline  # noqa: E402
from tetraear_tpu.api import PipelineConfig as JaxConfig  # noqa: E402
from tetraear_tpu.ref import golden as jax_golden  # noqa: E402
from tetraear_tpu_torch import golden  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.voice import viterbi  # noqa: E402

FS = 2.4e6
TWO = (-250e3, 250e3)


def _two_carriers(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = min(len(a), len(b))
    t = np.arange(n) / FS
    return (a[:n] * np.exp(-2j * np.pi * 250e3 * t)
            + b[:n] * np.exp(2j * np.pi * 250e3 * t)).astype(np.complex64)


@pytest.fixture(scope="module")
def captures():
    """The captures of test_voice_rf, made by the JAX package's
    golden_voice_iq (the port's copy is held equal to it)."""
    gv = jax_golden.golden_voice_iq
    return {
        "one": gv(golden.speech(6), fs=FS, snr_db=25, seed=5),
        "stolen": gv(golden.speech(8), fs=FS, snr_db=28, seed=7,
                     stolen_every=4),
        "two": _two_carriers(
            gv(golden.speech(6, 57, 0), fs=FS, seed=5, stolen_every=3),
            gv(golden.speech(6, 44, 1), fs=FS, seed=6)),
        "two_long": _two_carriers(
            gv(golden.speech(20, 57, 0), fs=FS, seed=15, stolen_every=5),
            gv(golden.speech(20, 44, 1), fs=FS, seed=16)),
    }


def _blocks(iq: np.ndarray, bl: int) -> list:
    return [iq[i * bl:(i + 1) * bl] for i in range(len(iq) // bl)]


def _config(pkg: str, offsets, block_len: int, **cfg):
    common = dict(sample_rate=FS, carrier_offsets_hz=tuple(offsets),
                  detect_gate=False, voice=True, validate=False,
                  block_len=block_len, **cfg)
    if pkg == "jax":
        return JaxConfig(**common)
    return PipelineConfig(device="cpu", **common)


def _run(pkg: str, iq, offsets, block_len: int, offline: bool = False,
         **cfg) -> tuple:
    """(audio chunks, pipeline) of one package on a capture: block by
    block through process_block, or run_offline two blocks a batch."""
    audio = []
    cls = JaxPipeline if pkg == "jax" else Pipeline
    pipe = cls(_config(pkg, offsets, block_len, **cfg),
               on_audio=audio.append)
    if offline:
        from tetraear_tpu_torch.golden import ArraySource
        pipe.run_offline(ArraySource(iq, FS), blocks_per_dispatch=2)
    else:
        for b in _blocks(iq, pipe.block_len):
            pipe.process_block(b)
    pipe.close()
    return audio, pipe


def _same_audio(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


CASES = {
    # capture, offsets, block_len, port config, JAX config, run_offline
    "one": ("one", (0.0,), 32_000, {}, {}, False),
    "stolen": ("stolen", (0.0,), 32_000, {}, {}, False),
    "threads": ("two", TWO, 32_000, {"voice_threads": 2}, {}, False),
    "lazy": ("two_long", TWO, 131_072, {}, {}, False),
    "lazy_threads": ("two_long", TWO, 131_072, {"voice_threads": 2},
                     {"voice_threads": 2}, False),
    "dense": ("two_long", TWO, 131_072, {"sparse_hits": False},
              {"sparse_hits": False}, False),
    "offline": ("two_long", TWO, 131_072, {}, {}, True),
    # the soft rows reach the sharded layer's parent-side finish
    "workers": ("two_long", TWO, 131_072, {"frame_workers": 2}, {}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pcm_equals_jax(captures, case, monkeypatch):
    name, offsets, bl, port_cfg, jax_cfg, offline = CASES[case]
    sizes = []
    orig = viterbi.channel_decode_batch

    def counting(soft, device=None):
        sizes.append(len(soft))
        return orig(soft, device=device)

    monkeypatch.setattr(viterbi, "channel_decode_batch", counting)
    want, jpipe = _run("jax", captures[name], offsets, bl, offline,
                       **jax_cfg)
    got, pipe = _run("port", captures[name], offsets, bl, offline,
                     **port_cfg)
    _same_audio(got, want)
    assert pipe.stats.voice_frames == jpipe.stats.voice_frames >= 5
    assert pipe.stats.stolen_frames == jpipe.stats.stolen_frames
    if name in ("stolen", "two", "two_long"):
        assert pipe.stats.stolen_frames >= 1
    if bl == 131_072:
        # two carriers, several slots a block: the batched decoder ran
        assert sizes and max(sizes) >= 2
        assert pipe.runner.lazy_soft == port_cfg.get("sparse_hits", True)


def test_checkpoint_split_mid_call(captures, tmp_path):
    """process_block over the two-carrier capture, killed after block 1
    (mid-call on both carriers) and restored onto a fresh Pipeline: the
    same PCM as the unsplit run, which is the JAX package's."""
    iq = captures["two_long"]
    want, _ = _run("jax", iq, TWO, 131_072)
    whole, _ = _run("port", iq, TWO, 131_072)
    _same_audio(whole, want)
    audio = []
    pipe = Pipeline(_config("port", TWO, 131_072), on_audio=audio.append)
    blocks = _blocks(iq, pipe.block_len)
    assert len(blocks) >= 4
    for b in blocks[:2]:
        pipe.process_block(b)
    assert audio, "no voice before the split"
    path = tmp_path / "voice.npz"
    pipe.save_checkpoint(path)
    pipe.close()
    saved = np.load(path)
    assert "aux_vhost" in saved and "aux_prev_soft" in saved
    pipe = Pipeline(_config("port", TWO, 131_072), on_audio=audio.append)
    pipe.load_checkpoint(path)
    for b in blocks[2:]:
        pipe.process_block(b)
    pipe.close()
    _same_audio(audio, want)


def test_jax_checkpoint_restores_into_the_port(captures, tmp_path):
    """A checkpoint the JAX package writes after block 1 (its host speech
    decoder states and previous soft planes) restores into the port's
    Pipeline, which goes on with the JAX package's unsplit PCM."""
    iq = captures["two_long"]
    want, _ = _run("jax", iq, TWO, 131_072)
    audio = []
    jpipe = JaxPipeline(_config("jax", TWO, 131_072), on_audio=audio.append)
    blocks = _blocks(iq, jpipe.block_len)
    for b in blocks[:2]:
        jpipe.process_block(b)
    path = tmp_path / "jax_voice.npz"
    jpipe.save_checkpoint(path)
    jpipe.close()
    assert "aux_vhost" in np.load(path)
    pipe = Pipeline(_config("port", TWO, 131_072), on_audio=audio.append)
    pipe.load_checkpoint(path)
    for b in blocks[2:]:
        pipe.process_block(b)
    pipe.close()
    _same_audio(audio, want)


def test_port_checkpoint_restores_into_jax(captures, tmp_path):
    """The other way: the port's checkpoint after block 1 restores into
    the JAX Pipeline, which goes on with its own unsplit PCM."""
    iq = captures["two_long"]
    want, _ = _run("jax", iq, TWO, 131_072)
    audio = []
    pipe = Pipeline(_config("port", TWO, 131_072), on_audio=audio.append)
    blocks = _blocks(iq, pipe.block_len)
    for b in blocks[:2]:
        pipe.process_block(b)
    path = tmp_path / "port_voice.npz"
    pipe.save_checkpoint(path)
    pipe.close()
    jpipe = JaxPipeline(_config("jax", TWO, 131_072), on_audio=audio.append)
    jpipe.load_checkpoint(path)
    for b in blocks[2:]:
        jpipe.process_block(b)
    jpipe.close()
    _same_audio(audio, want)


def test_voice_is_on_by_default_and_synthesis_stays_on_the_host(
        monkeypatch):
    """On the CPU the default synthesizes on the host; device_voice=True
    builds the device pool (on the pipeline's device), and with
    device_voice=None the TETRAEAR_DEVICE_VOICE variable decides, an
    explicit bool winning over it (as the JAX package resolves it)."""
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool

    def pool_of(env=None, **cfg):
        if env is None:
            monkeypatch.delenv("TETRAEAR_DEVICE_VOICE", raising=False)
        else:
            monkeypatch.setenv("TETRAEAR_DEVICE_VOICE", env)
        pipe = Pipeline(PipelineConfig(device="cpu", **cfg))
        try:
            if cfg.get("voice", True):
                assert pipe.voice is not None and pipe.voice.working
                assert pipe.runner.fetch_soft
            return pipe._voice_device
        finally:
            pipe.close()

    assert pool_of() is None
    pool = pool_of(device_voice=True, device_voice_slots=3)
    assert isinstance(pool, DeviceSpeechPool)
    assert pool.slots == 3 and pool.device.type == "cpu"
    assert isinstance(pool_of("1"), DeviceSpeechPool)
    assert pool_of("0") is None
    assert pool_of("1", device_voice=False) is None
    assert isinstance(pool_of("0", device_voice=True), DeviceSpeechPool)
    assert pool_of(device_voice=True, voice=False) is None


def test_fleet_capture_voice_carriers_decode_to_their_parameters():
    """golden.fleet_capture's voice carriers: each slot's coded bits
    channel-decode (C++ decoder, hard +-127 bits) to the returned
    parameters, stolen slots included."""
    from tetraear_tpu_torch import native
    codec = native.codec()
    offsets = [-12_500.0, 12_500.0, 37_500.0]
    iq, params = golden.fleet_capture(2.304e6, offsets, [0], 20_000,
                                      seed=3, voice={1: 0, 2: 3})
    assert iq.shape == (20_000,) and sorted(params) == [1, 2]
    bits, want = golden.voice_stream(golden.speech(6, 41, 1), 3, seed=4)
    vp = codec.VoiceProcessor()
    for s, exp in enumerate(want):
        slot = bits[s * 510:(s + 1) * 510]
        if exp[0, 0]:
            got = vp.channel_decode_stolen(
                np.where(slot[238:454] > 0, 127, -127).astype(np.int16))
        else:
            got = vp.channel_decode(codec.bits_to_codec_block(
                np.concatenate([slot[:216], slot[238:454]])))
        np.testing.assert_array_equal(got, exp)
    assert want[2, 0, 0] == 1 and want[5, 0, 0] == 1


def _summary_of(out: str) -> dict:
    import json
    return json.loads(out[out.rindex("\n{") + 1:])


def test_cli_listen_voice_equals_jax(capsys):
    """``listen --source synthetic-voice`` with two synthesis threads: the
    summary's voice counts equal the JAX package's CLI on the same
    source, and every voice frame's line carries the speaker sign."""
    from tetraear_tpu.cli import main as jax_main
    from tetraear_tpu_torch.cli import main
    args = ["listen", "--source", "synthetic-voice", "--max-blocks", "3"]
    assert jax_main(args) == 0
    want = _summary_of(capsys.readouterr().out)
    assert main(args + ["--device", "cpu", "--voice-threads", "2",
                        "--show-invalid"]) == 0
    out = capsys.readouterr().out
    got = _summary_of(out)
    assert got["voice_frames"] == want["voice_frames"] > 0
    assert got["stolen_frames"] == want["stolen_frames"]
    assert out.count("\U0001f50a") == got["voice_frames"]
