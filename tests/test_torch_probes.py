"""The port's three measurement instruments (tetraear_tpu_torch/dsp/
probes.py) on the CPU, where each wrapper runs its plain version:

  bit_place      against an independent numpy packing and against the
                 fused back half's own carried tail;
  ops_probe      against the jax.numpy operations of
                 perf/mosaic_ops_probe.py on that probe's inputs;
  iir_recursion  against the recursion of perf/scan_overhead_probe.py
                 (jax.lax.scan over the reference's basic operations).

Tolerances: integers and the exact operations bit for bit; the float
functions within 2e-6 of max(1, |reference|); the reduction within 1e-5
of its value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.dsp import probes  # noqa: E402

TAILBITS = ck.TAILBITS


def _place_inputs(seed, c, ns, tr, n_valid):
    rng = np.random.default_rng(seed)
    hard = rng.integers(0, 4, (c, ns)).astype(np.uint8)
    hard[:, n_valid:] = 0
    bt = np.zeros((c, tr * 128), np.float32)
    bt[:, :TAILBITS] = rng.integers(0, 2, (c, TAILBITS))
    dsel = rng.integers(0, 3, c).astype(np.int32)
    return hard, bt.reshape(c, tr, 128), dsel


@pytest.mark.parametrize("ns,n_valid,k_max", [
    (512, 0, 500), (512, 257, 500), (512, 512, 512), (2048, 2033, 2033),
    (2048, 2031, 2033), (128, 100, 128)])
def test_bit_place_equals_numpy_packing(ns, n_valid, k_max):
    c, tr = 3, 10
    z_rows = ck.z_rows_for(ns // 32)
    hard, bt, dsel = _place_inputs(ns + n_valid, c, ns, tr, n_valid)
    z, bt2 = probes.bit_place(torch.from_numpy(hard), torch.from_numpy(bt),
                              torch.from_numpy(dsel), k_max, z_rows)
    bits = np.zeros((c, z_rows * 128 + TAILBITS), np.uint8)
    bits[:, :TAILBITS] = bt.reshape(c, -1)[:, :TAILBITS]
    bits[:, TAILBITS:TAILBITS + 2 * ns:2] = hard >> 1
    bits[:, TAILBITS + 1:TAILBITS + 2 * ns:2] = hard & 1
    want_z = np.packbits(bits[:, :z_rows * 128], axis=1,
                         bitorder="little").view(np.uint32)
    assert z.dtype == torch.int32 and tuple(z.shape) == (c, 4 * z_rows)
    np.testing.assert_array_equal(z.numpy().view(np.uint32), want_z)
    want_bt2 = np.zeros((c, tr * 128), np.float32)
    for r in range(c):
        off = 2 * k_max - 4 + 2 * int(dsel[r])
        want_bt2[r, :TAILBITS] = bits[r, off:off + TAILBITS]
    np.testing.assert_array_equal(bt2.numpy().reshape(c, -1), want_bt2)


@pytest.mark.parametrize("n_valid", [0, 300, 509, 512])
def test_bit_place_gives_the_back_halfs_carried_tail(n_valid):
    """From the back half's soft bits (msb = soft0 > 0, lsb = soft1 > 0
    on valid symbols) the placement alone rebuilds its next bit tail."""
    c, p, tr, drop, k_max = 3, 16, 10, 8, 510
    sy, ns = p // 4, 128 * (p // 4)
    rng = np.random.default_rng(40 + n_valid)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    _, bt, dsel = _place_inputs(n_valid, c, ns, tr, n_valid)
    sc = randn(c, 16)
    sc[:, 4] = float(n_valid)
    bsel = torch.from_numpy(rng.integers(0, 4, c).astype(np.int32))
    args = (randn(c, 2, 128, p), torch.from_numpy(bt), randn(c, 2, 128, 1),
            randn(c, 2, 1, p), sc, bsel, torch.from_numpy(dsel), drop,
            k_max)
    z_rows = ck.z_rows_for(p)
    _, _, soft, bt2, _, _ = ck.fused_backhalf(*args)
    flat = soft.transpose(2, 3).reshape(c, 2, ns)
    valid = torch.arange(ns)[None, :] < n_valid
    hard = (2 * (flat[:, 0] > 0) + (flat[:, 1] > 0)) * valid
    _, got = probes.bit_place(hard.to(torch.uint8).contiguous(), args[1],
                              args[6], k_max, z_rows)
    assert sy == 4 and torch.equal(got, bt2)


def test_bit_place_rejects_a_short_row():
    hard, bt, dsel = _place_inputs(1, 2, 512, 10, 512)
    with pytest.raises(ValueError):
        probes.bit_place(torch.from_numpy(hard), torch.from_numpy(bt),
                         torch.from_numpy(dsel), 500, 12)


def _ops_reference():
    """The probe's own inputs and its jax.numpy functions."""
    import jax
    import jax.numpy as jnp
    x = np.linspace(0.1, 6.0, 8 * 128, dtype=np.float32).reshape(8, 128)
    y = (x * 0.5 + 0.3).astype(np.float32)
    a = np.arange(128 * 64, dtype=np.float32).reshape(128, 64)
    col = np.arange(128, dtype=np.float32)
    lam = np.arange(64)[:, None]
    sel = np.where(lam == 4 * np.arange(16)[None, :] + 3, 2.0,
                   0.0).astype(np.float32)

    def red(v):
        row = np.zeros(128, np.float32)
        row[0], row[1] = jnp.sum(v), jnp.sum(v * v)
        return row

    return {
        "cos": (x, None, jnp.cos), "sin": (x, None, jnp.sin),
        "floor": (x, None, jnp.floor),
        "mod": (x, y, jnp.mod), "arctan2": (x, y, jnp.arctan2),
        "exp": (x, None, jnp.exp), "rsqrt": (x, None, jax.lax.rsqrt),
        "round": (x, None, jnp.round),
        "sign_select": (x, None, lambda v: jnp.where(v < 3.0, v, -v)),
        "bcast_col": (a, col, lambda v, w: v * w[:, None]),
        "iota_sel_mm": (a, None, lambda v: v @ sel),
        "scalar_red_row": (a, None, red),
    }


@pytest.mark.parametrize("op", sorted(probes.OPS))
def test_ops_probe_equals_the_jax_operation(op):
    a, b, fn = _ops_reference()[op]
    want = np.asarray(fn(a) if b is None else fn(a, b), np.float32)
    got = probes.ops_probe(op, torch.from_numpy(a),
                           None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    if op == "scalar_red_row":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    elif probes.OPS[op][2]:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.max(np.abs(got - want)
                      / np.maximum(1.0, np.abs(want))) <= 2e-6


def test_ops_probe_checks_its_operands():
    a = torch.zeros(8, 128)
    with pytest.raises(ValueError):
        probes.ops_probe("tan", a)
    with pytest.raises(ValueError):
        probes.ops_probe("cos", a, a)
    with pytest.raises(TypeError):
        probes.ops_probe("mod", a)
    with pytest.raises(ValueError):
        probes.ops_probe("bcast_col", a, a)


def _iir_jax(a_np, x_np):
    """perf/scan_overhead_probe.py's xla formulation: lax.scan over the
    10-tap saturating step in the reference's basic operations."""
    import jax
    import jax.numpy as jnp
    from tetraear_tpu.voice import jfixed as F
    a = jnp.asarray(a_np)

    def step(m, xi):
        acc = F.L_shr(F.L_deposit_h(xi), 4)
        for k in range(10):
            acc = F.L_msu0(acc, a[:, k], m[..., k])
        y = F.store_hi(acc, 4)
        return jnp.concatenate([y[..., None], m[..., :-1]], axis=-1), y

    m0 = jnp.zeros((a_np.shape[0], 10), jnp.int32)
    m, ys = jax.lax.scan(step, m0, jnp.asarray(x_np))
    return np.asarray(ys), np.asarray(m)


@pytest.mark.parametrize("n,b,a_max,x_max", [
    (60, 64, 2000, 3000),          # the probe's ranges: one subframe
    (240, 16, 2000, 3000),
    (120, 32, 30000, 32767),       # unstable filter: L_sub saturates
    (1, 8, 2000, 3000)])
def test_iir_recursion_equals_the_jax_scan(n, b, a_max, x_max):
    rng = np.random.default_rng(n + b)
    a = rng.integers(-a_max, a_max, (b, 10)).astype(np.int32)
    x = rng.integers(-x_max, x_max, (n, b)).astype(np.int32)
    want_y, want_m = _iir_jax(a, x)
    y, m = probes.iir_recursion(torch.from_numpy(a), torch.from_numpy(x))
    assert y.dtype == torch.int32 and m.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(m.numpy(), want_m)


def test_probes_count_no_launch_on_the_cpu():
    ck.reset_launches()
    a = torch.ones(8, 128)
    probes.ops_probe("cos", a)
    probes.iir_recursion(torch.zeros(4, 10, dtype=torch.int32),
                         torch.zeros(3, 4, dtype=torch.int32))
    assert {k: ck.launches[k] for k in ("bit_place", "ops_probe",
                                        "iir_recursion")} == {
        "bit_place": 0, "ops_probe": 0, "iir_recursion": 0}


@pytest.mark.parametrize("kind", probes.INT_RATE_KINDS)
def test_int_rate_plain_equals_python_integers(kind):
    """The register-only rate loop's plain version against the same
    rounds in Python integers (the yardstick kernel of chip_smoke.py's
    integer bound; it has no TPU counterpart)."""
    n, iters, mask, m32 = 256, 3, probes.INT_RATE_MASK, 0xFFFFFFFF
    out = probes.int_rate(kind, iters, torch.empty(n, dtype=torch.int32))
    for tid in (0, 1, 77, 255):
        r = [((tid + 1) * 2654435761 + 40503 * i) & m32 for i in range(8)]
        for _ in range(iters):
            for i in range(8):
                nxt = r[(i + 1) & 7]
                r[i] = {"logic": (r[i] & mask) ^ nxt,
                        "popc": bin(r[i]).count("1") ^ nxt,
                        "add": (r[i] + mask + nxt) & m32}[kind]
        acc = 0
        for v in r:
            acc ^= v
        assert int(out[tid]) & m32 == acc


def test_int_rate_rejects_other_kinds_and_sizes():
    with pytest.raises(ValueError):
        probes.int_rate("mul", 1, torch.empty(256, dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.int_rate("logic", 1, torch.empty(100, dtype=torch.int32))


def _syn_filt_python(a, x, mem):
    """Syn_Filt in Python integers: each product subtracted and the sum
    saturated in turn, the rounding, the saturating shift by 4, the high
    word."""
    def sat(v):
        return max(-2 ** 31, min(2 ** 31 - 1, v))
    y, m = [], list(mem)
    for xi in x:
        L = xi * 4096
        for j in range(1, 11):
            L = sat(L - a[j] * m[10 - j])
        L = sat(L + 2048)
        L = sat(L * 16)
        out = L >> 16
        y.append(out)
        m = m[1:] + [out]
    return y, m


@pytest.mark.parametrize("scale", [1, 8])
def test_synth_chain_plain_equals_python_integers(scale):
    """acelp_decode's synthesis chain probe, plain route: subframes in
    order with the memory carried, against Syn_Filt in Python integers
    (scale 8 saturates)."""
    rng = np.random.default_rng(5 + scale)
    n = 3
    a = np.clip(rng.integers(-3000 * scale, 3000 * scale + 1, (n, 11)),
                -32768, 32767).astype(np.int32)
    a[:, 0] = 4096
    x = np.clip(rng.integers(-1000 * scale, 1000 * scale + 1, (n, 60)),
                -32768, 32767).astype(np.int32)
    mem = rng.integers(-2000, 2001, 10).astype(np.int32)
    y, m, cycles = probes.synth_chain(torch.from_numpy(a),
                                      torch.from_numpy(x),
                                      torch.from_numpy(mem))
    want_m = [int(v) for v in mem]
    for s in range(n):
        want_y, want_m = _syn_filt_python([int(v) for v in a[s]],
                                          [int(v) for v in x[s]], want_m)
        assert y[s].tolist() == want_y
    assert m.tolist() == want_m and cycles.tolist() == [0]


def test_synth_chain_rejects_other_sizes():
    z = torch.zeros
    with pytest.raises(ValueError):
        probes.synth_chain(z(65, 11, dtype=torch.int32),
                           z(65, 60, dtype=torch.int32),
                           z(10, dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.synth_chain(z(2, 11, dtype=torch.int32),
                           z(2, 59, dtype=torch.int32),
                           z(10, dtype=torch.int32))
