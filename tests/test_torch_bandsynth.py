"""The staged register transform of csrc/band_synth.cu on the CPU.

The CUDA kernel runs the band's inverse DFT as 2 to 4 radix-8 / radix-16
stages, decimation in frequency and in place, with the digit reversal
folded into the last stage's addresses and the inverse taken as the
forward transform on data with re and im exchanged.
``cuda_kernels.band_plan`` is its stage plan and
``cuda_kernels.band_synth_staged`` that order of steps in plain torch;
both are held here against the plain version of the kernel (the
reference's three float32 matmuls) and against the JAX Pallas kernel in
interpret mode, in the kernel's three forms.

Tolerances, the kernel's own: y within 1e-5 of its RMS, the phasor
within 2e-5 of the band power (the phasor is a signed sum of |y_k|^2, so
an error of e RMS in y moves it by at most about 2e of that power).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import pallas_kernels as pk  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.dsp.channelizer import synth_tables  # noqa: E402

BANDS = [512, 1024, 2048, 4096, 8192, 16384]
FORMS = ["y_and_phasor", "y_only", "phasor_only"]


def band_inputs(n_band: int, c: int, seed: int) -> tuple:
    """(planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im, twre,
    twim, P) as numpy arrays: random spectrum rows and filters, starts
    and shifts at their extremes."""
    rng = np.random.default_rng(seed)
    p = n_band // 128
    n_rolls, r_rows = 5, 2 * p + 9
    planes = rng.standard_normal((2, r_rows, 128)).astype(np.float32)
    h1 = rng.standard_normal((2, n_rolls, p, 128)).astype(np.float32)
    rs = rng.integers(0, r_rows - p + 1, c).astype(np.int32)
    ds = rng.integers(0, n_rolls, c).astype(np.int32)
    rs[0], rs[-1] = 0, r_rows - p
    ds[0], ds[-1] = n_rolls - 1, 0
    return (planes, h1, rs, ds, *synth_tables(n_band), p)


def as_torch(args):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def check(y, ph, y_ref, ph_ref, form):
    rms = float(y_ref.double().pow(2).mean().sqrt())
    power = float(y_ref.double().pow(2).sum(dim=(1, 2, 3)).max())
    if form != "phasor_only":
        assert y.shape == y_ref.shape
        assert float((y - y_ref).abs().max()) <= 1e-5 * rms
    if form != "y_only":
        assert ph.shape == ph_ref.shape
        assert float((ph - ph_ref).abs().max()) <= 2e-5 * power
        assert not ph[:, :, 2:].any()


@pytest.mark.parametrize("n_band", [128, 256] + BANDS)
def test_band_plan_covers_every_length(n_band):
    plan = ck.band_plan(n_band)
    assert 1 << sum(plan) == n_band
    assert set(plan) <= {3, 4} and list(plan) == sorted(plan)
    assert 2 <= len(plan) <= 4


def test_band_plan_rejects_other_lengths():
    with pytest.raises(ValueError):
        ck.band_plan(3 * 128)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_band", BANDS)
def test_staged_transform_equals_plain(n_band, form):
    args = as_torch(band_inputs(n_band, 4, seed=n_band))
    p = args[-1]
    for drop in (0, 2 * p):
        y_ref, ph_ref = ck.band_synth_plain(*args, drop)
        y, ph = ck.band_synth_staged(
            *args[:4], p, None if form == "y_only" else drop)
        assert (ph is None) == (form == "y_only")
        check(y, ph, y_ref, ph_ref, form)


@pytest.mark.parametrize("n_band", [128, 256])
def test_staged_transform_small_bands_y_only(n_band):
    """Two-stage plans: bands under 512 points take the y-only form (the
    phasor needs 4 | P)."""
    args = as_torch(band_inputs(n_band, 3, seed=n_band))
    y_ref, _ = ck.band_synth_plain(*args, None)
    y, ph = ck.band_synth_staged(*args[:4], args[-1], None)
    assert ph is None
    check(y, None, y_ref, None, "y_only")
    np.testing.assert_array_equal(ck.band_synth_y(*args).numpy(),
                                  y_ref.numpy())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_band", [512, 2048])
def test_staged_transform_equals_jax_pallas(n_band, form):
    np_args = band_inputs(n_band, 8, seed=7 * n_band)
    p = np_args[-1]
    drop = 2 * p
    kw = {"y_only": {}, "y_and_phasor": {"phasor_drop": drop},
          "phasor_only": {"phasor_drop": drop, "y_out": False}}[form]
    want = pk.band_synth(*(jnp.asarray(a) for a in np_args[:-1]), p,
                         interpret=True, **kw)
    args = as_torch(np_args)
    y, ph = ck.band_synth_staged(*args[:4], p,
                                 None if form == "y_only" else drop)
    y_ref, ph_ref = ck.band_synth_plain(*args, drop)
    if form == "y_only":
        y_jax, ph_jax = torch.from_numpy(np.array(want)), ph_ref
    elif form == "phasor_only":
        y_jax, ph_jax = y_ref, torch.from_numpy(np.array(want))
    else:
        y_jax, ph_jax = (torch.from_numpy(np.array(w)) for w in want)
    check(y, ph, y_jax, ph_jax.reshape(ph_ref.shape), form)


@pytest.mark.parametrize("form", FORMS)
def test_wrappers_on_cpu_take_the_plain_version(form):
    args = as_torch(band_inputs(1024, 3, seed=1))
    drop = 16
    y_ref, ph_ref = ck.band_synth_plain(*args, drop)
    before = dict(ck.launches)
    if form == "y_only":
        np.testing.assert_array_equal(ck.band_synth_y(*args).numpy(),
                                      y_ref.numpy())
    elif form == "phasor_only":
        np.testing.assert_array_equal(ck.band_synth_ph(*args, drop).numpy(),
                                      ph_ref.numpy())
    else:
        y, ph = ck.band_synth(*args, drop)
        np.testing.assert_array_equal(y.numpy(), y_ref.numpy())
        np.testing.assert_array_equal(ph.numpy(), ph_ref.numpy())
    assert ck.launches == before
