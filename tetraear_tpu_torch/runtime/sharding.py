"""Carrier x time sharding over a mesh of devices
(tetraear_tpu/runtime/sharding.py).

Two parallel axes:

  * ``carrier``: each mesh entry owns a slice of the carrier bank end to
    end; no communication.
  * ``time``: a long capture is cut into segments, and each shard needs
    the tail of its left neighbour's segment (filter memory), an
    overlap-save halo.

Inside a shard the demod is stateless given the halo: filter memory
comes from the halo samples, and the NCO phase at a segment boundary is
computed in closed form with exact integer cycle arithmetic, so no state
flows from one time shard to the next.  The sync hit counts are summed
over the whole mesh.

A mesh entry names a ``torch.device`` and the rank of the process that
owns it.  A process runs each of its own shards on that shard's device,
one after the other.  A halo between two shards of one process is a
tensor copy (``Tensor.to``); between two processes it is a send and a
receive (``torch.distributed.batch_isend_irecv``), all of a phase's
issued at once so that no process blocks on a receive its neighbour has
not reached.  The hit count is all-reduced, and every process all-gathers
the other processes' shards so that each returns the whole result.
Where the JAX step runs every shard's front half, then the halo
``ppermute``, then every back half, ``ShardedFFTDemod`` runs the same
three phases over its local shards.

A mesh may name one device several times: a *virtual* mesh, whose shards
run one after the other on that device (the counterpart of the JAX
tests' virtual CPU devices).  On one card its wall time is no scaling
figure.

Kernels: the FFT path's band extraction runs ``band_extract_rows`` on
aligned grids and ``band_extract`` on every other grid (the JAX step's
row and element gathers); each carrier shard's ``ExtractPlan`` is made at
construction, so a call reads nothing back to the host.  The wideband
transform is ``torch.fft.fft`` (XLA's FFT in the JAX step), the
synthesis the channelizer's matmul ``_synth``, the back half plain torch
(as XLA computes it there).

This is the offline / throughput path.  The streaming path with carried
state is runtime/stream.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import channelizer as chan_mod
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.dsp import design, kernels, sync, timing
from tetraear_tpu_torch.dsp.pipeline import plan_granularity


class Mesh:
    """An n-D array of devices with named axes (``jax.sharding.Mesh``'s
    shape and names), and the rank of the process that owns each entry.

    ``devices``: an array-like of ``torch.device`` (or names); ``ranks``:
    an int array of the same shape (default: all 0, one process)."""

    def __init__(self, devices, axis_names, ranks=None):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            self.devices[i] = torch.device(d)
        self.devices = self.devices.reshape(shape)
        self.ranks = (np.zeros(shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(shape))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D mesh")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local(self, rank: int | None = None) -> list:
        """Index tuples of the entries ``rank`` (default: this process)
        owns, in C order."""
        rank = _rank() if rank is None else rank
        return [tuple(int(i) for i in idx)
                for idx in np.argwhere(self.ranks == rank)]

    def axis_devices(self, axis: str | None = None) -> list:
        """The devices along ``axis`` (default: the first axis), the other
        axes at index 0: where a one-axis sharding (payload rows, voice
        slots) puts its shards, in order."""
        axis = axis or self.axis_names[0]
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(
            self.shape[axis], -1)[:, 0])


def _dist():
    """torch.distributed when a process group is up, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def _comm_device(dev: torch.device) -> torch.device:
    """Where a tensor must lie for the process group's backend: the
    shard's card for NCCL, the CPU for gloo."""
    return dev if _dist().get_backend() == "nccl" else torch.device("cpu")


def visible_devices() -> list:
    """Every visible card (raises without one, as ``resolve`` does)."""
    resolve(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_carrier_shards: int, n_time_shards: int,
              devices=None) -> Mesh:
    """A ("carrier", "time") mesh over the first n_c * n_t ``devices``
    (default: every visible card).  A list may name a device more than
    once: a virtual mesh, as the tests (``["cpu"] * 8``) and
    ``chip_smoke.py`` (one card, serialised shards) use."""
    devices = visible_devices() if devices is None else [
        resolve(d) for d in devices]
    need = n_carrier_shards * n_time_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        dev[i] = d
    return Mesh(dev.reshape(n_carrier_shards, n_time_shards),
                ("carrier", "time"))


def plan_input_halo(plan: design.ResamplePlan, rrc_len: int,
                    granularity: int, warmup_symbols: int = 16) -> int:
    """Overlap-save halo in *input-rate* samples covering every stage's
    filter memory + RRC + timing warmup, rounded up to the block
    granularity.  Off-by-one here silently corrupts sync rates
    (SURVEY.md section 7 hard parts), so everything rounds up."""
    halo = 0.0
    decim = 1.0
    for st in plan.stages:
        h = math.ceil((len(st.taps) - 1) / st.up)
        halo += h * decim
        decim *= st.down / st.up
    halo += (rrc_len - 1) * decim                 # RRC at the output rate
    halo += warmup_symbols * design.SPS * decim   # timing + interp warmup
    return int(math.ceil(halo / granularity)) * granularity


def _check_phase_range(n_time: int, steps: np.ndarray, what: str) -> None:
    """The JAX step computes t * step in int32; the port in int64.  The two
    agree while no product reaches 2^31."""
    if len(steps) and n_time * int(np.max(steps)) >= 2 ** 31:
        raise ValueError(f"{what}: {n_time} time shards x step "
                         f"{int(np.max(steps))} overflow the reference's "
                         f"int32 phase")


def _bits_hits(hard: torch.Tensor) -> torch.Tensor:
    """(C, K) symbols -> (C, 2K - 21) sync hit mask (corr >= 0.90 over the
    interleaved MSB/LSB bits)."""
    bits = torch.stack([hard >> 1, hard & 1], dim=2).reshape(
        hard.shape[0], -1)
    return sync.sync_correlate(bits) >= 0.90


def _left_halos(mesh: Mesh, local: list, tails: dict, shape: tuple,
                tag0: int) -> dict:
    """For each local shard (ci, ti): shard (ci, ti - 1)'s ``tails`` entry
    (a float32 tensor of ``shape``) on this shard's device, zeros at ti = 0
    (ppermute's fill).  Tails of local neighbours are copied; the others
    arrive by one batch of sends and receives over every shard pair whose
    owners differ, issued in one global order on every process."""
    rank = _rank()
    got, ops, pending = {}, [], []
    for ci, ti in local:
        dev = mesh.devices[ci, ti]
        if ti == 0:
            got[(ci, ti)] = torch.zeros(shape, dtype=torch.float32,
                                        device=dev)
        elif mesh.ranks[ci, ti - 1] == rank:
            got[(ci, ti)] = tails[(ci, ti - 1)].to(dev, non_blocking=True)
    dist = _dist()
    n_c, n_t = mesh.devices.shape
    for ci in range(n_c):
        for ti in range(1, n_t):
            src, dst = int(mesh.ranks[ci, ti - 1]), int(mesh.ranks[ci, ti])
            if src == dst or rank not in (src, dst):
                continue
            tag = tag0 + ci * n_t + ti
            if rank == src:
                buf = tails[(ci, ti - 1)].to(
                    _comm_device(mesh.devices[ci, ti - 1])).contiguous()
                ops.append(dist.P2POp(dist.isend, buf, dst, tag=tag))
            else:
                buf = torch.empty(shape, dtype=torch.float32,
                                  device=_comm_device(mesh.devices[ci, ti]))
                ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
                pending.append(((ci, ti), buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for key, buf in pending:
        got[key] = buf.to(mesh.devices[key])
    return got


def _finish(mesh: Mesh, local: list, shards: dict, hits: int,
            names: tuple) -> dict:
    """Local shard outputs {(ci, ti): {name: (C_local, K...) tensor}} and
    this process's hit count -> the reference's host dict: each name
    (C, n_time, K...) in numpy, ``sync_hits`` summed over the mesh.  With
    a process group, hits are all-reduced and the shards all-gathered."""
    host = {key: {n: t.cpu().numpy() for n, t in out.items()}
            for key, out in shards.items()}
    dist = _dist()
    if dist:
        anchor = mesh.devices[local[0]] if local else torch.device("cpu")
        t = torch.tensor([hits], dtype=torch.int64,
                         device=_comm_device(anchor))
        dist.all_reduce(t)
        hits = int(t.item())
        if dist.get_world_size() > 1:
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, host)
            host = {k: v for part in parts for k, v in part.items()}
    n_c, n_t = mesh.devices.shape
    res = {}
    for n in names:
        rows = [np.stack([host[(ci, ti)][n] for ti in range(n_t)], axis=1)
                for ci in range(n_c)]
        res[n] = np.concatenate(rows, axis=0)
    res["sync_hits"] = int(hits)
    return res


class ShardedDemod:
    """Carrier+time sharded demod over a mesh (offline/batch mode).

    Input: (C, N) per-carrier IQ (or (N,) broadcast wideband on the host
    side), C divisible by mesh carrier axis, N divisible by time axis *
    granularity.  Output per shard covers its own segment; the halo region
    is demodulated twice (left shard's tail, right shard's warmup) and the
    frame layer dedups by sync position.
    """

    def __init__(self, fs: float, freqs_hz, mesh: Mesh,
                 seg_len: int, sps: int = design.SPS):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.n_cshard = mesh.shape["carrier"]
        if self.n_carriers % self.n_cshard:
            raise ValueError("carriers must divide carrier-shard count")
        self.sps = sps
        self.plan = design.build_resample_plan(self.fs,
                                               design.SYMBOL_RATE * sps)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        self.granularity = plan_granularity(self.plan, sps)
        if seg_len % self.granularity:
            raise ValueError(f"seg_len {seg_len} % granularity "
                             f"{self.granularity} != 0")
        self.seg_len = seg_len
        self.halo = plan_input_halo(self.plan, len(self.rrc),
                                    self.granularity)
        if self.halo > seg_len:
            raise ValueError(f"halo {self.halo} longer than a segment "
                             f"({seg_len})")
        self.block_len = self.halo + seg_len       # per-shard processed span
        self.nco = kernels.nco_tables(self.freqs_hz, self.fs, self.block_len)
        # exact per-carrier cycle advance for one segment and for the halo
        # (closed-form boundary phase), in int64: the JAX step's int32
        # products t * seg_step equal these below 2^31
        fs_i = int(round(self.fs))
        fi = np.round(self.freqs_hz).astype(np.int64)
        self.seg_step = (seg_len % fs_i) * (fi % fs_i) % fs_i
        self.halo_cycles = (int(self.halo) % fs_i) * (fi % fs_i) % fs_i
        _check_phase_range(self.n_time, self.seg_step, "ShardedDemod")
        self.c_local = self.n_carriers // self.n_cshard
        self._tabs: dict = {}

    def _n_out_syms(self, n_in: int) -> int:
        """Symbols produced from n_in input-rate samples (plan ratio)."""
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n // self.sps

    def _tables(self, ci: int, dev: torch.device) -> tuple:
        """Carrier shard ci's NCO tables on ``dev`` (cached)."""
        key = (ci, str(dev))
        if key not in self._tabs:
            sl = slice(ci * self.c_local, (ci + 1) * self.c_local)
            self._tabs[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(
                    self.nco[n][sl])).to(dev)
                for n in ("coarse", "fine", "block_step"))
        return self._tabs[key]

    def _shard_step(self, ci: int, ti: int, x: torch.Tensor,
                    left: torch.Tensor) -> tuple:
        """Shard (ci, ti): x (seg_len,) complex64 segment, left (halo, 2)
        the left neighbour's tail -> ({hard, soft, valid}, hits)."""
        dev = x.device
        c = self.c_local
        xx = torch.cat([kernels.r2c(left), x])          # (halo + seg,)
        xx = xx[None, :].expand(c, xx.shape[0])
        fs_i = int(round(self.fs))
        sl = slice(ci * c, (ci + 1) * c)
        start = torch.remainder(
            torch.remainder(ti * torch.from_numpy(self.seg_step[sl]), fs_i)
            - torch.from_numpy(self.halo_cycles[sl]), fs_i)
        cycles0 = start.to(torch.float32).to(dev)
        coarse, fine, step = self._tables(ci, dev)
        y, _ = kernels.nco_mix(xx, cycles0, coarse, fine, step,
                               self.nco["fs"])
        y, _ = kernels.plan_apply(
            self.plan, y, kernels.init_plan_histories(self.plan, c, dev))
        y, _ = kernels.fir_apply(
            self.rrc, y, torch.zeros((c, len(self.rrc) - 1),
                                     dtype=torch.complex64, device=dev))
        syms, valid, _ = timing.timing_recover(
            y, timing.init_timing_state(c, dev))
        hard, soft, _ = timing.dqpsk_demod(
            syms, valid, torch.zeros(c, dtype=torch.complex64, device=dev))
        hits = _bits_hits(hard).sum()
        return {"hard": hard, "soft": soft, "valid": valid}, hits

    def run(self, iq: np.ndarray) -> dict:
        """Demod a capture of length n_time * seg_len (per-carrier shared
        wideband input broadcast on the carrier axis).  Every process
        passes the whole capture and reads its own shards' segments."""
        iq = np.asarray(iq, np.complex64)
        need = self.n_time * self.seg_len
        if len(iq) < need:
            raise ValueError(f"need {need} samples, got {len(iq)}")
        local = self.mesh.local()
        seg = {}
        for ci, ti in local:
            part = iq[ti * self.seg_len:(ti + 1) * self.seg_len]
            seg[(ci, ti)] = torch.from_numpy(part).to(
                self.mesh.devices[ci, ti])
        tails = {k: kernels.c2r(v[v.shape[0] - self.halo:])
                 for k, v in seg.items()}
        left = _left_halos(self.mesh, local, tails, (self.halo, 2), 0)
        shards, hits = {}, 0
        for key in local:
            shards[key], h = self._shard_step(*key, seg[key], left[key])
            hits += int(h)
        return _finish(self.mesh, local, shards, hits,
                       ("hard", "soft", "valid"))


class ShardedFFTDemod:
    """Carrier x time sharded demod using the FFT channelizer frontend.

    The scale path for 10k+ carriers: each time shard transforms one
    wideband segment (its left halo from the neighbour shard), extracts
    and synthesizes its *local* slice of the carrier bank, and runs the
    polyphase / timing / demod back half on it with a second, channel-rate
    halo from the neighbour, so no state flows between shards
    (closed-form integer NCO phase at segment boundaries, as in
    ShardedDemod).

    A call runs three phases over the local shards: front (wideband
    halo, FFT, band extraction, synthesis, phase), exchange (the
    channel-rate halo), back (resample, RRC, timing, demod, mask, sync).
    """

    def __init__(self, fs: float, freqs_hz, mesh: Mesh,
                 sps: int = design.SPS):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.n_cshard = mesh.shape["carrier"]
        if self.n_carriers % self.n_cshard:
            raise ValueError("carriers must divide carrier-shard count")
        self.sps = sps
        decim = chan_mod.choose_decim(self.fs)
        self.plan = design.build_resample_plan(self.fs / decim,
                                               design.SYMBOL_RATE * sps)
        self.plan_gran = plan_granularity(self.plan, sps)
        # the time mesh axis is this path's segmentation (each shard
        # transforms its own window)
        self.chan = chan_mod.FFTChannelizer(
            self.fs, self.freqs_hz, back_granularity=self.plan_gran,
            kernel_synth=False)
        self.seg_len = self.chan.block_len
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        # channel-rate halo for the back half: the wideband halo covers
        # only the channel filter, so each shard also receives the left
        # neighbour's channelized tail, covering the back half's memory
        # and a whole 255-symbol slot (boundary frames are then clean in
        # one shard; the frame layer dedups by sync position)
        self.back_halo = plan_input_halo(self.plan, len(self.rrc),
                                         self.plan_gran, warmup_symbols=300)
        if self.back_halo > self.chan.n_out:
            raise ValueError(f"back halo {self.back_halo} longer than a "
                             f"segment's {self.chan.n_out} channel samples")
        # corrupted-prefix length in output symbols (filter memory only)
        mem = plan_input_halo(self.plan, len(self.rrc), 1, warmup_symbols=4)
        self.n_bad_syms = self._out_len(mem) // sps + 4
        # time shard 0 has no left neighbour: its halo input is zeros, so
        # its whole halo span (not just the filter memory) is masked
        self.halo_syms = self._out_len(self.back_halo) // sps + 8
        # exact per-carrier cycle step of one segment, (k_c * seg_len) mod
        # nfft, in int64 (the JAX step's int32 products agree below 2^31)
        nfft = self.chan.nfft
        self.seg_cycles = ((self.chan.k_c % nfft)
                           * (self.seg_len % nfft) % nfft).astype(np.int64)
        _check_phase_range(self.n_time, self.seg_cycles, "ShardedFFTDemod")
        self.c_local = self.n_carriers // self.n_cshard
        self._rot: dict = {}
        # each carrier shard's extraction plan, made once from host starts
        ch = self.chan
        self.plans = []
        for ci in range(self.n_cshard):
            starts = ch.band_start[ci * self.c_local:(ci + 1) * self.c_local]
            if ch.aligned:
                self.plans.append(ck.ExtractPlan(
                    "rows", (starts // 128).astype(np.int32),
                    ch.n_band // 128, (ch.nfft + ch.n_band) // 128))
            else:
                self.plans.append(ck.ExtractPlan(
                    "pairs", starts.astype(np.int32), ch.n_band,
                    ch.nfft + ch.n_band))

    def _out_len(self, n_in: int) -> int:
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n

    def _rotation(self, ci: int, ti: int, dev: torch.device) -> torch.Tensor:
        """Shard (ci, ti)'s (C_local,) phase correction exp(-2 pi j cycles /
        nfft), cycles = (ti * seg_cycles) mod nfft in closed form; made on
        the device once a shard (cached), so a step copies nothing to it."""
        key = (ci, ti, str(dev))
        if key not in self._rot:
            ch = self.chan
            sl = slice(ci * self.c_local, (ci + 1) * self.c_local)
            cycles = torch.remainder(
                ti * torch.from_numpy(self.seg_cycles[sl]), ch.nfft)
            ang = cycles.to(torch.float32).to(dev) * float(
                np.float32(2.0 * np.pi / ch.nfft))
            self._rot[key] = torch.complex(torch.cos(ang), -torch.sin(ang))
        return self._rot[key]

    def _front(self, ci: int, ti: int, x: torch.Tensor,
               left: torch.Tensor) -> torch.Tensor:
        """Shard (ci, ti)'s channelized segment: x (seg_len,) complex64,
        left (overlap, 2) the neighbour's wideband tail -> (C_local, n_out)
        complex64 at global phase."""
        ch = self.chan
        dev = x.device
        c = self.c_local
        big = ch._wideband_fft(torch.cat([kernels.r2c(left), x]))
        x_ext = torch.cat([big, big[:ch.n_band]])
        if ch.aligned:
            planes = torch.stack([x_ext.real, x_ext.imag]).reshape(2, -1, 128)
            got = ck.band_extract_rows(planes, self.plans[ci],
                                       ch.n_band // 128)
            nat = torch.complex(got[:, 0], got[:, 1]).reshape(c, ch.n_band)
        else:
            got = ck.band_extract(torch.view_as_real(x_ext).contiguous(),
                                  self.plans[ci], ch.n_band)
            nat = torch.view_as_complex(got)
        # natural-order synthesis: h1_band is the rolled table, _synth and
        # the (-1)^k sign replace the per-block fftshift
        band = nat * ch._dev("h1_band", dev)[None, :]
        y = ch._synth(band) * float(np.float32(1.0 / ch.decim))
        y = y[:, ch.drop:ch.drop + ch.n_out]
        y = y * ch._dev("sign", dev)[None, :]
        return y * self._rotation(ci, ti, dev)[:, None]

    def _back(self, ti: int, y: torch.Tensor, left: torch.Tensor) -> tuple:
        """Back half of a shard on y (C_local, n_out) with its channel-rate
        halo left (C_local, back_halo, 2) -> ({hard, soft, valid}, hits as
        a device scalar)."""
        dev = y.device
        c = self.c_local
        y = torch.cat([kernels.r2c(left), y], dim=1)
        y, _ = kernels.plan_apply(
            self.plan, y, kernels.init_plan_histories(self.plan, c, dev))
        y, _ = kernels.fir_apply(
            self.rrc, y, torch.zeros((c, len(self.rrc) - 1),
                                     dtype=torch.complex64, device=dev))
        y = y[:, :y.shape[1] - y.shape[1] % self.sps]
        syms, valid, _ = timing.timing_recover(
            y, timing.init_timing_state(c, dev))
        hard, soft, _ = timing.dqpsk_demod(
            syms, valid, torch.zeros(c, dtype=torch.complex64, device=dev))
        # mask the filter transient at the head of the halo region; shard
        # 0 received zeros, so it masks its whole halo span
        n_bad = self.halo_syms if ti == 0 else self.n_bad_syms
        valid = valid & (torch.arange(valid.shape[1], device=dev)
                         >= n_bad)[None, :]
        hits = _bits_hits(hard).sum()
        return {"hard": hard, "soft": soft, "valid": valid}, hits

    def upload(self, iq: np.ndarray) -> dict:
        """This process's segments of a capture of n_time * seg_len samples
        on their shards' devices: {(ci, ti): (seg_len,) complex64}.  Every
        process passes the whole capture."""
        iq = np.asarray(iq, np.complex64)
        need = self.n_time * self.seg_len
        if len(iq) < need:
            raise ValueError(f"need {need} samples, got {len(iq)}")
        seg = {}
        for ci, ti in self.mesh.local():
            part = iq[ti * self.seg_len:(ti + 1) * self.seg_len]
            seg[(ci, ti)] = torch.from_numpy(part).to(
                self.mesh.devices[ci, ti])
        return seg

    def step(self, seg: dict) -> tuple:
        """The mesh step on uploaded segments: front, exchange, back over
        the local shards -> ({(ci, ti): {hard, soft, valid}}, [hits a
        shard as device scalars])."""
        mesh, local, ch = self.mesh, self.mesh.local(), self.chan
        # front: the wideband halo, then every local shard's channelizer
        tails = {k: kernels.c2r(v[v.shape[0] - ch.overlap:])
                 for k, v in seg.items()}
        left = _left_halos(mesh, local, tails, (ch.overlap, 2), 0)
        ys = {k: self._front(*k, seg[k], left[k]) for k in local}
        del tails, left
        # exchange: the channel-rate halo (the left shard's channelized
        # tail, at global phase like this shard's output)
        tails = {k: kernels.c2r(y[:, y.shape[1] - self.back_halo:])
                 for k, y in ys.items()}
        left = _left_halos(mesh, local, tails,
                           (self.c_local, self.back_halo, 2),
                           mesh.size + 1)
        del tails
        # back: every local shard's back half
        shards, hits = {}, []
        for k in local:
            shards[k], h = self._back(k[1], ys.pop(k), left.pop(k))
            hits.append(h)
        return shards, hits

    def run(self, iq: np.ndarray) -> dict:
        """Demod a capture of n_time * seg_len samples -> hard / soft /
        valid (C, n_time, K) and sync_hits."""
        shards, hits = self.step(self.upload(iq))
        return _finish(self.mesh, self.mesh.local(), shards,
                       sum(int(h) for h in hits), ("hard", "soft", "valid"))
