"""Several processes: runtime/distributed.py and the sharded demods over a
``torch.distributed`` gloo group on the CPU.

  * ``init_distributed`` is a no-op (False) without the TETRAEAR_*
    variables; ``make_host_mesh`` lays the time rows out inside one
    process and the carrier rows across processes, as the JAX function
    does (its shape is held against the reference's in one process).
  * Two processes over loopback, this file run as the worker script
    (``python tests/test_torch_distributed.py OUT``, rank and group from
    the TETRAEAR_* variables): ``ShardedDemod`` and ``ShardedFFTDemod`` on
    a (2, 1) and a (2, 2) mesh with the carrier axis across processes,
    and on a (1, 2) mesh with the time axis across processes (both FFT
    halos and the conv halo cross by send / receive).  Every process's
    result (all-gathered, hits all-reduced) equals the one-process
    virtual mesh's bit for bit.
  * Each worker gets ``communicate(timeout=...)`` and is killed in
    ``finally``, so nothing can hang the suite.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FS_CONV, SEG_CONV = 2.4e6, 48_000
FS_FFT = 2.304e6
OFFSETS = [(i - 2) * 25_000 + 12_500.0 for i in range(4)]
PATHS = ("conv", "fft")


def _layouts():
    """name -> (devices, ranks) of the two-process meshes."""
    return {
        "2x1 carriers across": ([["cpu"], ["cpu"]], [[0], [1]]),
        "2x2 carriers across": (None, None),      # make_host_mesh
        "1x2 time across": ([["cpu", "cpu"]], [[0, 1]]),
    }


def _mesh(name: str, n_processes: int, single: bool):
    """The layout's mesh; ``single``: the same shape with every entry in
    this process (the virtual mesh it is held against)."""
    from tetraear_tpu_torch.runtime.distributed import make_host_mesh
    from tetraear_tpu_torch.runtime.sharding import Mesh
    devices, ranks = _layouts()[name]
    if devices is None:
        m = make_host_mesh(1, devices=["cpu", "cpu"], n_processes=2)
        devices, ranks = m.devices, m.ranks
    return Mesh(devices, ("carrier", "time"),
                None if single else ranks)


def _run_all(iq_conv, iq_fft, n_processes: int, single: bool) -> dict:
    from tetraear_tpu_torch.runtime.sharding import (ShardedDemod,
                                                     ShardedFFTDemod)
    out = {}
    for name in _layouts():
        mesh = _mesh(name, n_processes, single)
        # two processes: each owns half the entries
        assert len(mesh.local()) == (mesh.size if single
                                     else mesh.size // n_processes)
        sd = ShardedDemod(fs=FS_CONV, freqs_hz=OFFSETS, mesh=mesh,
                          seg_len=SEG_CONV)
        out[(name, "conv")] = sd.run(iq_conv)
        sdf = ShardedFFTDemod(fs=FS_FFT, freqs_hz=OFFSETS, mesh=mesh)
        out[(name, "fft")] = sdf.run(iq_fft)
    return out


def _captures():
    from tetraear_tpu_torch import golden
    from tetraear_tpu_torch.runtime.sharding import ShardedFFTDemod, Mesh
    seg_fft = ShardedFFTDemod(fs=FS_FFT, freqs_hz=OFFSETS,
                              mesh=Mesh([["cpu"]], ("carrier", "time"))
                              ).seg_len
    return (golden.fleet_capture(FS_CONV, OFFSETS, range(4), 2 * SEG_CONV,
                                 seed=3),
            golden.fleet_capture(FS_FFT, OFFSETS, range(4), 2 * seg_fft,
                                 seed=4))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the tests ----------------------------------------------------------------

def test_init_distributed_is_a_noop_without_the_variables(monkeypatch):
    import torch.distributed as dist
    from tetraear_tpu_torch.runtime.distributed import init_distributed
    for v in ("TETRAEAR_COORDINATOR", "TETRAEAR_NUM_PROCESSES",
              "TETRAEAR_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_make_host_mesh_layout():
    """Time rows inside a process, carrier rows across processes,
    process-major; one process matches the JAX function's shape."""
    from tetraear_tpu.runtime import distributed as jdist
    from tetraear_tpu_torch.runtime.distributed import make_host_mesh
    for cph in (1, 2, 4, 8):
        want = jdist.make_host_mesh(cph)
        got = make_host_mesh(cph, devices=["cpu"] * 8)
        assert got.devices.shape == want.devices.shape
        assert got.axis_names == ("carrier", "time")
        assert not got.ranks.any()
    m = make_host_mesh(2, devices=["cpu"] * 4, n_processes=3)
    assert m.shape == {"carrier": 6, "time": 2}
    np.testing.assert_array_equal(m.ranks, [[0, 0], [0, 0], [1, 1], [1, 1],
                                            [2, 2], [2, 2]])
    m = make_host_mesh(1, devices=["cpu"] * 2, n_processes=2)
    np.testing.assert_array_equal(m.ranks, [[0, 0], [1, 1]])


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Run this file as two gloo workers; returns the captures and each
    worker's results."""
    tmp_path = tmp_path_factory.mktemp("gloo")
    iq_conv, iq_fft = _captures()
    np.save(tmp_path / "iq_conv.npy", iq_conv)
    np.save(tmp_path / "iq_fft.npy", iq_fft)
    port = _free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(REPO),
                       TETRAEAR_COORDINATOR=f"127.0.0.1:{port}",
                       TETRAEAR_NUM_PROCESSES="2",
                       TETRAEAR_PROCESS_ID=str(rank),
                       GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(tmp_path)], env=env,
                cwd=tmp_path, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=240)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    return iq_conv, iq_fft, got


def _key(name, path, field):
    return f"{name}|{path}|{field}"


@pytest.fixture(scope="module")
def virtual_run(gloo_run):
    iq_conv, iq_fft, _ = gloo_run
    return _run_all(iq_conv, iq_fft, 2, single=True)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", sorted(_layouts()))
def test_two_gloo_processes_equal_the_virtual_mesh(gloo_run, virtual_run,
                                                   name, path):
    """Both processes: hard, soft, valid and sync_hits equal the
    one-process virtual mesh's bit for bit."""
    got = gloo_run[2]
    res = virtual_run[(name, path)]
    assert res["sync_hits"] > 0
    for r in range(2):
        for field in ("hard", "soft", "valid", "sync_hits"):
            a = got[r][_key(name, path, field)]
            assert a.dtype == np.asarray(res[field]).dtype
            assert a.tobytes() == np.asarray(res[field]).tobytes(), (
                f"rank {r} {name} {path} {field}")


# -- the worker ---------------------------------------------------------------

def _worker(out_dir: Path) -> None:
    from tetraear_tpu_torch.runtime.distributed import init_distributed
    import torch.distributed as dist
    assert init_distributed(device="cpu")
    assert init_distributed(device="cpu")              # a second call
    iq_conv = np.load(out_dir / "iq_conv.npy")
    iq_fft = np.load(out_dir / "iq_fft.npy")
    res = _run_all(iq_conv, iq_fft, dist.get_world_size(), single=False)
    flat = {_key(name, path, field): np.asarray(v)
            for (name, path), out in res.items() for field, v in out.items()}
    np.savez(out_dir / f"out{dist.get_rank()}.npz", **flat)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(Path(sys.argv[1]))
