"""The ETSI basic operations a speech frame needs (chip_smoke.py's
frame_ops, a counting build of voice/csrc), from which chip_smoke.py
takes acelp_decode's bound, held per frame against what the decoder's code
does: each subframe whose pitch lag has a fraction adds the
interpolation, a BFI frame drops the parameter decoding, and a stream's
counts are each frame's from the state the frames before it leave.
CPU only (g++); tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

from tetraear_tpu_torch.voice import acelp_tables as T  # noqa: E402
from tetraear_tpu_torch.voice import speech  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

# Pred_Lt's interpolation, a sample: 32 L_mac0, the doubling L_add and
# round_w; and its tests of the fraction, sub(frac, 1) then
# sub(frac, -1) (etsi_acelp_dec.cpp Pred_Lt)
INTERP_OPS = 60 * (32 + 1 + 1)
FRAC_TEST_OPS = {1: 1, -1: 2}
# what a BFI frame does not do: D_Lsp334 (two joint corrections of
# sub + add, each 3 more where it applies, and 9 ordering subs), the
# pitch lags (8 basic operations in subframe 1 with index <= 196, 8 in
# each other), Ener_Update (15) instead of the decrement (2), a subframe
LSP_OPS, PITCH_OPS, ENER_SAVED = 4 + 9, 8 + 3 * 8, 4 * (15 - 2)


def base_params(seed: int) -> np.ndarray:
    """[BFI, 23 parameters] of a good frame whose four subframes all
    have the lag 60 with no fraction: index 122 in subframe 1, delta 17
    (t0_min + 5) in the others."""
    rng = np.random.default_rng(seed)
    prm = np.zeros(24, np.int64)
    prm[1:] = [rng.integers(0, 1 << int(nb)) for nb in T.BITNO]
    prm[4] = 122
    prm[[9, 14, 19]] = 17
    return prm


def second_frame_ops(first: np.ndarray, seconds: list) -> np.ndarray:
    """The counts of each frame of ``seconds``, decoded after ``first``
    by a fresh decoder."""
    prm = np.stack([np.stack([first, p]) for p in seconds])
    n = len(seconds)
    state = [x.numpy() for x in speech.init_state(n, "cpu")]
    ops = smoke.frame_ops(state, speech.prm2bits(prm),
                            np.ones((n, 2), bool))
    return ops[:, 1]


@pytest.mark.parametrize("seed", [3, 4])
def test_each_fractional_subframe_adds_the_interpolation(seed):
    """The same frame with one subframe's lag given a fraction (same t0,
    so the same sharpening): the count grows by the interpolation and
    the fraction tests, and by nothing else."""
    g = base_params(seed)
    variants = []
    for k, (index, frac) in enumerate([(123, 1), (121, -1), (18, 1),
                                       (16, -1), (18, 1)]):
        p = g.copy()
        p[4 if k < 2 else 9 + 5 * (k - 2)] = index
        variants.append((p, frac))
    ops = second_frame_ops(g, [g] + [p for p, _ in variants])
    for (p, frac), got in zip(variants, ops[1:]):
        assert got - ops[0] == INTERP_OPS + FRAC_TEST_OPS[frac]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_a_bfi_frame_drops_the_parameter_decoding(seed):
    """A BFI frame after a good frame G replays G's parameters with G's
    lag (60 in every subframe): against G decoded again it does the
    same work less D_Lsp334, the lag decoding and Ener_Update (for the
    decrement); its payload bits are never read."""
    g = base_params(seed)
    lsp = np.concatenate([
        np.asarray(T.DICO1_CLSP).reshape(-1, 3)[g[1]],
        np.asarray(T.DICO2_CLSP).reshape(-1, 3)[g[2]],
        np.asarray(T.DICO3_CLSP).reshape(-1, 4)[g[3]]])
    joints = int(917 - lsp[2] + lsp[3] > 0) + int(1245 - lsp[5] + lsp[6] > 0)
    bfi = g.copy()
    bfi[0] = 1
    other = bfi.copy()
    other[1:] = (g[1:] + 5) % (1 << np.asarray(T.BITNO))
    ops = second_frame_ops(g, [g, bfi, other])
    assert ops[0] - ops[1] == LSP_OPS + 3 * joints + PITCH_OPS + ENER_SAVED
    assert ops[1] == ops[2]


def test_a_stream_counts_each_frame_from_the_state_before_it():
    """frame_ops over streams with BFI runs and holes in ``valid`` equals
    counting each valid frame on its own from the state the plain
    decoder leaves before it; invalid frames count 0."""
    s, n = 3, 5
    rng = np.random.default_rng(91)
    fr = rng.integers(0, 2, (s, n, 138)).astype(np.int32)
    fr[:, :, 0] = rng.random((s, n)) < 0.25
    fr[0, 1:3, 0] = 1                        # a run of BFI
    valid = rng.random((s, n)) > 0.2
    valid[1, 2] = False                      # a hole
    st = speech.init_state(s, "cpu")
    whole = smoke.frame_ops(st, fr, valid)
    assert not whole[~valid].any() and (whole[valid] > 10_000).all()
    for f in range(n):
        alone = smoke.frame_ops(st, fr[:, f:f + 1], valid[:, f:f + 1])
        np.testing.assert_array_equal(alone[:, 0], whole[:, f],
                                      err_msg=f"frame {f}")
        st, _ = speech.decode_block(
            st, torch.from_numpy(np.ascontiguousarray(fr[:, f:f + 1])),
            torch.from_numpy(np.ascontiguousarray(valid[:, f:f + 1])))


def test_the_state_must_have_the_decoder_layout():
    st = [x.numpy() for x in speech.init_state(2, "cpu")]
    with pytest.raises(ValueError):
        smoke.frame_ops(st[:-1], np.zeros((2, 1, 138), np.int32),
                          np.ones((2, 1), bool))
