"""The JAX package's symbol-clock recovery with the port's repaired wrap.

``tetraear_tpu_torch/dsp/timing.py`` keeps a symbol whose clock snaps
into [0, 1); the JAX package's ``dsp.timing.timing_recover`` wraps it a
symbol on and drops it.  The tests that hold the port's classic chain
to the JAX package over whole captures use the reference with that one
line repaired, compiled in memory from its own source (the package
stays as it is); ``test_torch_classic.py`` holds the port to the
unmodified package on the off-air fixture, where the two differ by the
one kept symbol.
"""

import inspect

import pytest

_REFERENCE_WRAP = "next_t = jnp.where(next_t < 1.0, next_t + SPS, next_t)"
_REPAIRED_WRAP = "next_t = jnp.where(next_t < 0.0, next_t + SPS, next_t)"


def jax_timing_recover_repaired():
    """The JAX package's ``dsp.timing.timing_recover`` with the port's
    repaired wrap and nothing else changed."""
    from tetraear_tpu.dsp import timing
    src = inspect.getsource(timing.timing_recover)
    if src.count(_REFERENCE_WRAP) != 1:
        raise AssertionError("the reference's wrap is not where it was")
    ns = dict(vars(timing))
    exec(compile(src.replace(_REFERENCE_WRAP, _REPAIRED_WRAP),
                 timing.__file__, "exec"), ns)
    return ns["timing_recover"]


@pytest.fixture
def repaired_timing(monkeypatch):
    """The JAX package's timing recovery with the port's repaired wrap
    (``jax_timing_recover_repaired``) for the length of one test."""
    from tetraear_tpu.dsp import timing
    monkeypatch.setattr(timing, "timing_recover",
                        jax_timing_recover_repaired())
