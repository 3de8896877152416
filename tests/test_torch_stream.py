"""The port's live streaming path vs the JAX reference, on the CPU.

``Pipeline.process_block`` (the detection gate, the capture-level AFC,
the device block step shared with ``run_offline``, the frame layer with
its deferred key search), seamless checkpoints, the worker-sharded frame
layer and the ``listen`` command.  Inputs are golden captures made from
seeds with numpy (the port's ``golden``), the same arrays for both
packages; the JAX package runs as its own tests run it on the CPU (its
fused path with TETRAEAR_FORCE_FUSED=1, the Pallas kernels in interpret
mode), the port its kernels' plain versions.

Tolerance: frame lists identical, field for field (``frame_key``).  The
conv frontend is compared from the zero state; the fft frontend from a
warmed state, block 0 run by JAX and carried across by the port's
``load_checkpoint`` of the JAX package's checkpoint, because the first
block's warm-up symbols follow the FFT's rounding (ROADMAP "Faults").
The detection gate is wall-clock based: its decisions are compared with
``loss_hysteresis_s=0``.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tetraear_tpu import api as jax_api  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder  # noqa: E402
from tetraear_tpu_torch.frame.parallel import ShardedFrameLayer  # noqa: E402
from tetraear_tpu_torch.golden import ArraySource, fleet_capture  # noqa: E402
from tetraear_tpu_torch.ref import golden, modulator  # noqa: E402
from tetraear_tpu_torch.runtime import checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
TEA1_KEY = bytes.fromhex("0123456789ABCDEF0123")      # common TEA1 key 2
TEA2_KEY = bytes.fromhex("FEDCBA9876543210FEDCBA9876543210")  # TEA2 key 3

# 2.4 Msps, conv frontend, per-carrier AFC: a clear and a TEA2 carrier
FS_RTL = 2.4e6
RTL_OFF = (0.0, 250_000.0)
RTL_BL = 48_000
RTL_CFG = dict(sample_rate=FS_RTL, carrier_offsets_hz=RTL_OFF,
               block_len=RTL_BL, validate=False)
# 2.304 MHz, fft frontend, no AFC: the fused path; a clear and a TEA1
# carrier
FS = 2.304e6
FUSED_OFF = (12_500.0, 37_500.0)
FUSED_CFG = dict(sample_rate=FS, carrier_offsets_hz=FUSED_OFF,
                 frontend="fft", carrier_afc=False, detect_gate=False,
                 validate=False)

KEY_FIELDS = ("carrier", "stream_symbol", "position", "burst_crc", "type",
              "type_name", "sds_message", "tdma", "encrypted", "decrypted",
              "key_used", "decrypted_bytes", "carrier_offset_hz",
              "frequency")


def frame_key(f):
    return {k: f.get(k) for k in KEY_FIELDS}


def keys(frames):
    return [frame_key(f) for f in frames]


def rtl_blocks():
    """Six blocks of the 2.4 Msps capture, a noise block after the third
    (the gate closes on it, and the stream resumes after it)."""
    iq = fleet_capture(FS_RTL, RTL_OFF, [0], 6 * RTL_BL, seed=31,
                       text="RTL", encrypted={1: ("TEA2", TEA2_KEY)})
    blocks = [iq[i * RTL_BL:(i + 1) * RTL_BL] for i in range(6)]
    rng = np.random.default_rng(32)
    noise = (0.01 * (rng.standard_normal(RTL_BL)
                     + 1j * rng.standard_normal(RTL_BL))).astype(np.complex64)
    return blocks[:3] + [noise] + blocks[3:]


def fused_blocks():
    bl = CarrierBankDemod(fs=FS, freqs_hz=list(FUSED_OFF),
                          frontend="fft").block_len
    iq = fleet_capture(FS, FUSED_OFF, [0], 4 * bl, seed=3, text="FUSED",
                       encrypted={1: ("TEA1", TEA1_KEY)})
    return [iq[i * bl:(i + 1) * bl] for i in range(4)]


def run_jax(cfg, blocks, ckpt_after=None, ckpt=None):
    """The JAX Pipeline block by block: (frame keys a block, statuses,
    AFC offsets a block); a checkpoint after block ``ckpt_after``."""
    statuses = []
    pipe = jax_api.Pipeline(jax_api.PipelineConfig(voice=False, **cfg),
                            on_status=statuses.append)
    out, afc = [], []
    for i, b in enumerate(blocks):
        out.append(keys(pipe.process_block(b)))
        afc.append(pipe.stats.afc_offset_hz)
        if i == ckpt_after:
            pipe.save_checkpoint(ckpt)
    pipe.close()
    return out, statuses, afc


def run_port(cfg, blocks, pipe=None):
    statuses = []
    if pipe is None:
        pipe = Pipeline(PipelineConfig(device=CPU, **cfg),
                        on_status=statuses.append)
    out, afc = [], []
    for b in blocks:
        out.append(keys(pipe.process_block(b)))
        afc.append(pipe.stats.afc_offset_hz)
    return out, statuses, afc


RTL_VARIANTS = {
    "device_scan": {},
    "host_scan": {"device_scan": False},
    "dense": {"sparse_hits": False},
}


@pytest.fixture(scope="module")
def rtl(tmp_path_factory):
    """The JAX runs of the 2.4 Msps capture: gate and capture AFC on,
    one run a variant; the device-scan run checkpoints after block 1."""
    blocks = rtl_blocks()
    ckpt = tmp_path_factory.mktemp("rtl") / "jax_rtl.npz"
    runs = {}
    for name, change in RTL_VARIANTS.items():
        cfg = dict(RTL_CFG, detect_gate=True, loss_hysteresis_s=0.0,
                   afc=True, **change)
        runs[name] = run_jax(cfg, blocks,
                             ckpt_after=1 if name == "device_scan" else None,
                             ckpt=ckpt)
    return blocks, runs, ckpt


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The JAX fused Pipeline over the 2.304 MHz capture, its checkpoint
    after block 0."""
    blocks = fused_blocks()
    ckpt = tmp_path_factory.mktemp("fused") / "jax_fused.npz"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TETRAEAR_FORCE_FUSED", "1")
        mp.setenv("TETRAEAR_NO_FUSED", "0")
        ref, _, _ = run_jax(FUSED_CFG, blocks, ckpt_after=0, ckpt=ckpt)
    return blocks, ref, ckpt


@pytest.mark.parametrize("variant", sorted(RTL_VARIANTS))
def test_process_block_conv_gate_afc_matches_jax(rtl, variant):
    """Conv frontend with per-carrier and capture-level AFC and the
    detection gate: frames, gate statuses and AFC offsets equal JAX's
    block by block; the noise block gives [] and "no signal" in both;
    the TEA2 carrier's frames come decrypted in both."""
    blocks, runs, _ = rtl
    want, want_status, want_afc = runs[variant]
    cfg = dict(RTL_CFG, detect_gate=True, loss_hysteresis_s=0.0, afc=True,
               **RTL_VARIANTS[variant])
    got, status, afc = run_port(cfg, blocks)
    assert got == want
    assert want[3] == [] and status == want_status == ["no signal"]
    assert afc == want_afc
    texts = {(f["carrier"], f["sds_message"]) for b in got for f in b
             if f["burst_crc"]}
    assert {(0, "[TXT] RTL 0"), (1, "[TXT] SECRET 1")} <= texts


def test_process_block_fused_matches_jax_checkpoint(fused, monkeypatch):
    """The fused path from JAX's state after block 0: the port restores
    the JAX Pipeline's checkpoint (leaves into its own state, extras and
    aux across) and its blocks 1-3 equal JAX's continuation; the TEA1
    carrier's text comes back decrypted, through one key search a block
    covering both cipher families (each block holds several encrypted
    frames)."""
    from tetraear_tpu_torch.crypto import batch as cbatch
    searches = []
    orig = cbatch.tea_decrypt_families

    def counting(payloads, tea1_keys, tea2_keys, device=None):
        searches.append((len(payloads), len(tea1_keys), len(tea2_keys),
                         device))
        return orig(payloads, tea1_keys, tea2_keys, device=device)

    monkeypatch.setattr(cbatch, "tea_decrypt_families", counting)
    blocks, want, ckpt = fused
    pipe = Pipeline(PipelineConfig(device=CPU, **FUSED_CFG))
    assert pipe.runner.fused is not None
    pipe.load_checkpoint(ckpt)
    got, _, _ = run_port(FUSED_CFG, blocks[1:], pipe=pipe)
    assert got == want[1:]
    assert len(searches) == len(blocks[1:]), searches
    assert all(n >= 2 and k1 and k2 for n, k1, k2, _ in searches)
    assert all(str(d) == CPU for *_, d in searches)
    dec = [f for b in got for f in b if f["carrier"] == 1 and f["decrypted"]]
    assert len(dec) >= 8
    assert all(f["sds_message"] == "[TXT] SECRET 1" for f in dec)


def test_process_block_classic_matches_jax_checkpoint(rtl):
    """The classic chain (carried device bit tail in aux) from the JAX
    Pipeline's checkpoint after block 1 equals JAX's continuation."""
    blocks, runs, ckpt = rtl
    cfg = dict(RTL_CFG, detect_gate=True, loss_hysteresis_s=0.0, afc=True)
    pipe = Pipeline(PipelineConfig(device=CPU, **cfg))
    pipe.load_checkpoint(ckpt)
    assert pipe.runner._tail_bits is not None
    got, _, _ = run_port(cfg, blocks[2:], pipe=pipe)
    assert got == runs["device_scan"][0][2:]


@pytest.mark.parametrize("path", ["classic", "fused"])
def test_process_block_equals_run_offline(fused, path):
    """For one capture, process_block block by block gives the frames
    run_offline gives in batches of two (the JAX package's
    test_decode_runner_matches_streaming_pipeline)."""
    if path == "fused":
        blocks, cfg = fused[0], FUSED_CFG
    else:
        blocks = rtl_blocks()
        blocks, cfg = blocks[:3] + blocks[4:], dict(RTL_CFG,
                                                    detect_gate=False)
    streamed = Pipeline(PipelineConfig(device=CPU, **cfg))
    got = [f for b in blocks for f in streamed.process_block(b)]
    offline = []
    pipe = Pipeline(PipelineConfig(device=CPU, **cfg),
                    on_frame=offline.append)
    stats = pipe.run_offline(ArraySource(np.concatenate(blocks),
                                         cfg["sample_rate"]),
                             blocks_per_dispatch=2)
    assert keys(got) == keys(offline)
    assert stats.blocks == streamed.stats.blocks == len(blocks)
    assert sum(f["burst_crc"] for f in got) >= 12


def split_run(cfg, blocks, split, path):
    """Blocks [:split] on one Pipeline, a checkpoint, the rest on a fresh
    one restored from it; all frames, both pipelines closed.  The MAC
    parser states (open fragment chains, network identity) of the fresh
    Pipeline after the restore must equal those at the checkpoint."""
    frames = []
    pipe = Pipeline(PipelineConfig(device=CPU, **cfg), on_frame=frames.append)
    try:
        for b in blocks[:split]:
            pipe.process_block(b)
        pipe.save_checkpoint(path)
        parsers = pipe._parser_states()
    finally:
        pipe.close()
    pipe2 = Pipeline(PipelineConfig(device=CPU, **cfg),
                     on_frame=frames.append)
    try:
        pipe2.load_checkpoint(path)
        assert parsers and pipe2._parser_states() == parsers
        for b in blocks[split:]:
            pipe2.process_block(b)
    finally:
        pipe2.close()
    return keys(frames)


@pytest.mark.parametrize("path,workers", [("classic", 0), ("fused", 0),
                                          ("classic", 2)])
def test_checkpoint_round_trip(fused, tmp_path, path, workers):
    """Split after block 1, 2 and n/2 into a fresh Pipeline: the frames
    (the one straddling the split included) equal the uninterrupted
    run's (test_seamless_checkpoint.py's frame key and more), on both
    paths and with the worker-sharded frame layer (one split there:
    each Pipeline spawns its workers); the MAC parsers' states travel
    too (split_run)."""
    if path == "fused":
        blocks, cfg = fused[0], FUSED_CFG
    else:
        blocks = rtl_blocks()
        blocks, cfg = blocks[:3] + blocks[4:], dict(RTL_CFG,
                                                    detect_gate=False)
    base = []
    pipe = Pipeline(PipelineConfig(device=CPU, **cfg), on_frame=base.append)
    for b in blocks:
        pipe.process_block(b)
    base = keys(base)
    assert sum(f["burst_crc"] for f in base) >= 12
    splits = (1, 2, len(blocks) // 2 + 1) if not workers else (2,)
    for split in splits:
        got = split_run(dict(cfg, frame_workers=workers), blocks, split,
                        tmp_path / f"s{split}.npz")
        assert got == base, split


def test_checkpoint_layout_and_checks(fused, tmp_path):
    """The .npz layout is the JAX package's, leaf for leaf: the port's
    checkpoint of the fused state has the JAX file's leaf count, shapes
    and dtypes and the JAX file's structure string (so the JAX package
    restores the port's file); restore_into rejects a wrong leaf count, a
    wrong shape and a wrong structure, and accepts the JAX file."""
    _, _, jax_ckpt = fused
    # the JAX file's configuration: voice off (no decoder states in aux)
    pipe = Pipeline(PipelineConfig(device=CPU, voice=False, **FUSED_CFG))
    path = tmp_path / "port.npz"
    pipe.save_checkpoint(path)
    mine, extra, aux = checkpoint.load_state(path)
    theirs, jextra, jaux = checkpoint.load_state(jax_ckpt)
    assert [(a.shape, a.dtype) for a in mine] == \
        [(a.shape, a.dtype) for a in theirs]
    # the structure string is the one jax.tree_util prints for the tree
    assert extra["__treedef__"] == jextra["__treedef__"]
    assert set(aux) == set(jaux) | {"batch_tail_hard", "batch_tail_soft",
                                    "batch_tail_valid"}
    state = checkpoint.restore_into(pipe.state, theirs,
                                    jextra["__treedef__"])
    assert state["bit_tail"].dtype == torch.float32
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_into(pipe.state, mine[:-1])
    bad = list(mine)
    bad[0] = np.zeros((3,) + bad[0].shape, bad[0].dtype)
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.restore_into(pipe.state, bad)
    with pytest.raises(ValueError, match="tree structure"):
        checkpoint.restore_into(pipe.state, mine, "PyTreeDef({})")


@pytest.mark.parametrize("kind", ["signal", "noise"])
def test_detect_signal_matches_jax(kind):
    """The gate's FFT power test, peak offset and spectrum equal JAX's on
    a signal block and on a noise block."""
    blocks = rtl_blocks()
    block = blocks[0] if kind == "signal" else blocks[3]
    cfg = dict(RTL_CFG, loss_hysteresis_s=0.0)
    want = jax_api.Pipeline(jax_api.PipelineConfig(
        voice=False, **cfg))._detect_signal(block)
    got = Pipeline(PipelineConfig(device=CPU, **cfg))._detect_signal(block)
    assert got[:2] == want[:2]
    assert got[0] is (kind == "signal")
    np.testing.assert_array_equal(got[2], want[2])


# -- the worker-sharded frame layer ----------------------------------------

@pytest.fixture(scope="module")
def layer():
    """One ShardedFrameLayer of four carriers on two workers for the
    module (spawning a worker imports torch)."""
    lay = ShardedFrameLayer(4, n_workers=2, auto_decrypt=True, device=CPU)
    yield lay
    lay.close()


def test_sharded_layer_matches_inprocess(layer):
    """Frame for frame equal to the in-process layer on the port's bank
    output, block by block (tests/unit/test_parallel_frames.py)."""
    offsets = [-250_000.0, 0.0, 250_000.0, 500_000.0]
    streams = [golden.build_stream(
        [golden.sds_text_payload(f"CARRIER {c} MSG {i}") for i in range(6)])
        for c in range(4)]
    iq = modulator.generate_multi_carrier(
        streams, fs=FS_RTL, offsets_hz=offsets, snr_db=25,
        rng=np.random.default_rng(21))
    bank = CarrierBankDemod(fs=FS_RTL, freqs_hz=offsets, block_len=RTL_BL)
    inproc = BatchedFrameDecoder(4, auto_decrypt=True, device=CPU)
    state = bank.init_state(CPU)
    total = 0
    for b in range(len(iq) // RTL_BL):
        out, state = bank.step(iq[b * RTL_BL:(b + 1) * RTL_BL], state)
        hard, soft, valid = (out[k].numpy() for k in ("hard", "soft",
                                                      "valid"))
        fa = inproc.process(hard, soft, valid)
        fb = layer.process(hard, soft, valid)
        assert len(fa) == len(fb), b
        for x, y in zip(fa, fb):
            assert set(x) == set(y)
            for k in x:
                if isinstance(x[k], np.ndarray):
                    np.testing.assert_array_equal(x[k], y[k])
                else:
                    assert x[k] == y[k], (b, k)
        total += len(fa)
    assert total >= 10
    np.testing.assert_array_equal(inproc._emitted_until,
                                  layer._inner._emitted_until)


def test_sharded_layer_worker_death_recovery(layer):
    """A worker killed mid-run is respawned with its watermarks restored
    from the parent's mirror, and its block replayed."""
    slot = golden.build_slot(golden.build_mac_resource_data_bits(
        golden.sds_text_payload("RECOVERY TEST")))[:510]
    sym_slot = (slot[0::2] * 2 + slot[1::2]).astype(np.uint8)
    w = 900
    syms = np.zeros((4, w), np.uint8)
    col = 150                       # pos = 300, start = 84, symbol 42
    start_bit = 2 * col - 216
    for ci in (0, 3):
        syms[ci, start_bit // 2:start_bit // 2 + 255] = sym_slot
    corr = np.zeros((4, 400), np.float32)
    corr[0, col] = corr[3, col] = 0.95
    layer._sym_base = np.zeros(4, np.int64)
    layer._emitted_until = np.zeros(4, np.int64)
    os.kill(layer._procs[0].pid, signal.SIGKILL)
    layer._procs[0].join(timeout=10)
    frames = layer.select_and_decode(
        syms, np.zeros((4, w, 2), np.float32), np.full(4, w, np.int64),
        np.zeros(4, np.int64), corr, np.zeros((4, 400), np.int32))
    assert {f["carrier"] for f in frames} == {0, 3}
    assert all("RECOVERY TEST" in (f.get("sds_message") or "")
               for f in frames)
    np.testing.assert_array_equal(frames[0]["bits"], slot)


def test_sharded_layer_parser_states_round_trip(layer):
    """The workers' MAC parser states (the checkpoint's ``parsers``) are
    read back as set, each carrier from the worker that owns it; a
    parser in its initial state is left out."""
    from tetraear_tpu_torch.frame.mac import MacParser
    fresh = layer.parser_states()
    states = {
        0: {"mcc": 262, "mnc": 1, "la": None, "colour_code": 5,
            "fragment": "82414c", "fragment_metadata": {
                "address": 1234, "encrypted": True, "mode": 1}},
        3: {"mcc": None, "mnc": None, "la": None, "colour_code": None,
            "fragment": "ff", "fragment_metadata": {}}}
    layer.set_parser_states(states)
    got = layer.parser_states()
    assert {ci: got[ci] for ci in states} == states
    assert set(got) - set(states) == set(fresh) - set(states)
    parser = MacParser()
    assert checkpoint.parser_state(parser) is None
    checkpoint.restore_parser(parser, states[0])
    assert parser.fragment_buffer == bytearray(b"\x82AL")
    assert checkpoint.parser_state(parser) == states[0]


def test_sharded_layer_parser_states_after_worker_failure(layer, caplog):
    """A worker that fails while it reads its parser states raises with
    its traceback; one that dies between the request and its answer is
    respawned, and its carriers' parser states are left out with a
    warning while the other worker's come back."""
    good = {"mcc": 262, "mnc": 1, "la": None, "colour_code": 5,
            "fragment": "82", "fragment_metadata": {}}
    blank = {"mcc": None, "mnc": None, "la": None, "colour_code": None,
             "fragment": "", "fragment_metadata": {}}
    layer.set_parser_states({2: dict(good, mcc="not a number")})
    with pytest.raises(RuntimeError, match="frame worker 1 failed"):
        layer.parser_states()
    layer.set_parser_states({0: good, 2: blank, 3: good})
    send = layer._send_with_respawn
    pid = layer._procs[0].pid

    def stop_then_kill(w, msg):
        if w == 0 and msg[0] == "get_parsers":
            os.kill(pid, signal.SIGSTOP)     # the request stays unread
            send(w, msg)
            os.kill(pid, signal.SIGKILL)
            layer._procs[0].join(timeout=10)
        else:
            send(w, msg)

    layer._send_with_respawn = stop_then_kill
    try:
        with caplog.at_level("WARNING"):
            got = layer.parser_states()
    finally:
        del layer._send_with_respawn
    assert got.get(3) == good and 0 not in got and 2 not in got
    assert "MAC parser states of carriers 0..1 are lost" in caplog.text
    assert layer._procs[0].is_alive() and layer._procs[0].pid != pid
    assert layer.parser_states().get(3) == good


def test_sharded_layer_set_keys_reaches_respawned_workers(layer):
    """Runtime keys reach live workers, the parent's templates, and a
    respawned worker (through the spawn arguments)."""
    key = "0123456789abcdef0123"
    want = ("TEA1", bytes.fromhex(key))
    layer.set_keys([key])
    assert want in layer._decrypt_template[0].user_keys
    assert want in layer._inner.decoders[0].user_keys
    layer._procs[1].kill()
    layer._procs[1].join()
    layer._send_with_respawn(1, ("set_emitted", {}))
    assert layer._spawn_args[2] == (key,)
    assert layer._procs[1].is_alive()


# -- the listen command ----------------------------------------------------

def test_cli_listen_imports_no_jax(tmp_path):
    """``listen --source synthetic`` streams two blocks on the CPU through
    Pipeline.run, and neither jax nor any module of the JAX package is in
    sys.modules afterwards."""
    code = (
        "import sys\n"
        "from tetraear_tpu_torch.cli import main\n"
        "rc = main(['listen', '--source', 'synthetic', '--max-blocks', '2',"
        " '--device', 'cpu', '--show-invalid'])\n"
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
    assert "JAX_FREE" in r.stdout and "Listening on" in r.stdout
    summary = json.loads(r.stdout[r.stdout.index("{\n"):
                                  r.stdout.rindex("\n}") + 2])
    assert summary["blocks"] == 2 and summary["device"] == "cpu"
    assert summary["crc_pass"] >= 2
