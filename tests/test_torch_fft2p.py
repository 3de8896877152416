"""The two-pass FFT of tetraear_tpu_torch.dsp.cuda_kernels on the CPU:
the host-made four-step twiddle tables, the pass-1 probe's plain
version with a plain pass 2 over the scratch layout G, and both against
the JAX Pallas kernel in interpret mode.

Tolerances: the product of the two float32 tables is two roundings and
one complex product off the float64 twiddle, under 3e-7; pass 1 + pass 2
in float32 against one float32 ``torch.fft`` of the window, 1e-5 of the
spectrum RMS; against the JAX transform (bf16x3 matrix products, error
2.8e-5 of the RMS) 1e-4 of the RMS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import pallas_kernels as pk  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402

GEOMETRIES = [(128, 128), (512, 512), (256, 128)]


def _window(n1, n2, o2, seed):
    rng = np.random.default_rng(seed)
    tail = rng.standard_normal((2, o2, n1)).astype(np.float32)
    x = rng.standard_normal((2, n2 - o2, n1)).astype(np.float32)
    return tail, x


def _rms(a):
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


@pytest.mark.parametrize("lg", [14, 18, 22, 25])
def test_fourstep_tables_multiply_to_the_twiddle(lg):
    nfft = 1 << lg
    hbits = (lg + 1) // 2
    whi, wlo = ck.fourstep_tables(nfft, hbits)
    assert whi.shape == (nfft >> hbits, 2) and wlo.shape == (1 << hbits, 2)
    assert whi.dtype == np.float32 and wlo.dtype == np.float32
    rng = np.random.default_rng(lg)
    i1 = rng.integers(0, 1 << (lg + 1) // 2, 50_000)
    k2 = rng.integers(0, 1 << lg // 2, 50_000)
    # the corners of the index range as well
    i1[:2], k2[:2] = (0, (1 << (lg + 1) // 2) - 1), (0, (1 << lg // 2) - 1)
    m = (i1 * k2) % nfft
    hi = whi[m >> hbits].view(np.complex64)[:, 0]
    lo = wlo[m & ((1 << hbits) - 1)].view(np.complex64)[:, 0]
    want = np.exp(-2j * np.pi * m.astype(np.float64) / nfft)
    assert np.abs(hi * lo - want).max() <= 3e-7


@pytest.mark.parametrize("wrap", [0, 2])
@pytest.mark.parametrize("o2", [0, 8, 64])
@pytest.mark.parametrize("n1,n2", GEOMETRIES)
def test_pass1_then_pass2_equals_fft2p_plain(n1, n2, o2, wrap):
    tail, x = _window(n1, n2, o2, seed=n1 + n2 + o2 + wrap)
    tail, x = torch.from_numpy(tail), torch.from_numpy(x)
    plan = ck.fft2p_plan(n1, n2)
    g = ck.fft2p_pass1(tail, x, n1, n2)           # CPU: the plain version
    assert tuple(g.shape) == (plan.la // plan.t2, plan.lb, plan.t2, 2)
    assert g.dtype == torch.float32 and g.is_contiguous()
    got = ck.fft2p_pass2_plain(g, n1, n2, wrap)
    want = ck.fft2p_plain(tail, x, n1, n2, wrap)
    assert got.shape == want.shape == (2, (n1 + wrap) * n2 // 128, 128)
    assert (got - want).abs().max().item() <= 1e-5 * _rms(want.numpy())


@pytest.mark.parametrize("n1,n2", GEOMETRIES)
def test_g_layout_is_tiled_by_pass2_rows(n1, n2):
    """G[k2 // t2, i1, k2 % t2] holds column i1's bin k2 times
    w^(i1 k2): checked against float64 numpy."""
    tail, x = _window(n1, n2, 8, seed=5)
    plan = ck.fft2p_plan(n1, n2)
    g = ck.fft2p_pass1_plain(torch.from_numpy(tail), torch.from_numpy(x),
                             n1, n2).numpy()
    win = np.concatenate([tail, x], axis=1).astype(np.float64)
    cols = np.fft.fft(win[0] + 1j * win[1], axis=0)            # (k2, i1)
    k2, i1 = np.meshgrid(np.arange(plan.la), np.arange(plan.lb),
                         indexing="ij")
    want = cols * np.exp(-2j * np.pi * (k2 * i1) / (n1 * n2))
    got = g[..., 0] + 1j * g[..., 1]                       # (la/t2, lb, t2)
    got = got.transpose(0, 2, 1).reshape(plan.la, plan.lb)
    assert np.abs(got - want).max() <= 1e-5 * _rms(np.abs(want))


@pytest.mark.parametrize("o2,wrap", [(8, 2), (0, 0)])
@pytest.mark.parametrize("n1,n2", GEOMETRIES)
def test_two_passes_match_jax_interpret(n1, n2, o2, wrap):
    tail, x = _window(n1, n2, o2, seed=n1 * 3 + n2 + o2)
    if o2:
        want = pk.fft2p_planes_spliced(jnp.asarray(tail), jnp.asarray(x),
                                       n1, n2, wrap_k1=wrap, interpret=True)
    else:
        want = pk.fft2p_planes(jnp.asarray(x), n1, n2, wrap_k1=wrap,
                               interpret=True)
    want = np.asarray(want)
    g = ck.fft2p_pass1(torch.from_numpy(tail), torch.from_numpy(x), n1, n2)
    got = ck.fft2p_pass2_plain(g, n1, n2, wrap).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * _rms(want)


@pytest.mark.parametrize("n1,n2,t1,t2,cl2", [
    (128, 128, 16, 16, 1), (512, 512, 16, 16, 1), (2048, 2048, 8, 8, 1),
    (8192, 4096, 4, 2, 4), (16384, 16384, 1, 1, 8)])
def test_plan_tiles_fit_one_block(n1, n2, t1, t2, cl2):
    plan = ck.fft2p_plan(n1, n2)
    assert (plan.la, plan.lb, plan.t1, plan.t2, plan.cl2) == (n2, n1, t1,
                                                              t2, cl2)
    assert plan.cl2 <= 8 and (plan.la // plan.t2) % plan.cl2 == 0
    assert plan.la * plan.t1 <= 16384 and plan.lb * plan.t2 <= 16384
    assert plan.la % plan.t2 == 0 and plan.lb % plan.t1 == 0
    assert 0 < plan.hbits < int(np.log2(n1 * n2))


def test_pass1_wrapper_contract():
    before = dict(ck.launches)
    g = ck.fft2p_pass1(torch.zeros(2, 8, 128), torch.zeros(2, 120, 128),
                       128, 128)
    assert g.device.type == "cpu" and ck.launches == before
    with pytest.raises(ValueError):
        ck.fft2p_pass1(torch.zeros(2, 8, 128, dtype=torch.float64),
                       torch.zeros(2, 120, 128), 128, 128)
    with pytest.raises(ValueError):
        ck.fft2p_pass1(torch.zeros(2, 8, 128), torch.zeros(2, 100, 128),
                       128, 128)
