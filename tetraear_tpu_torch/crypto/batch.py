"""Batched TEA key search on the card (tetraear_tpu/crypto/batch.py).

The reference tries ~40 keys per encrypted frame in a Python loop
(tetraear/core/decoder.py:683-783).  Here the whole keys x payloads
product is one launch of the hand-written ``tea_search`` kernel
(dsp/csrc/tea.cu): a thread an 8-byte block (decrypt) or a (key,
payload) pair (search, the score in registers), so a fleet bruteforces
every encrypted frame of a block without a Python loop over keys.  The
live path's deferred decryption (``batch_decrypt_frames``) covers both
cipher families with one upload, one launch and one fetch a block
(``tea_decrypt_families``).

Semantics are identical to ``crypto.tea`` (itself bit-exact vs the
reference ciphers) and to the JAX package's functions of the same names.
The host helpers (key and payload word packing, the key plan and
selection loop of ``batch_decrypt_frames``) keep the original's code.

Each public function takes ``device`` (``None``: the card; ``"cpu"``
runs the kernels' plain versions).  ``tea_decrypt_batch`` and
``tea_key_search`` also take the JAX functions' ``mesh=`` / ``axis=``
(a runtime/sharding.Mesh): the payload rows are padded with zero rows
until the axis size divides them (``_pad_rows``), each shard's rows go
to the device of its mesh entry, where its own ``tea_search`` launch
runs, and the rows come back in order with the padding cut off.  The
keys x payloads product has no term across payloads, so the results are
bit-identical to the unsharded call, with no collective.

Kernel wrappers (``tea_decrypt_fused``, ``tea_decrypt``, ``tea_search``,
``tea_decrypt_pairs``) follow ``dsp/cuda_kernels``' dispatch rule: CPU
tensors run the plain version (int64 tensors, every addition,
subtraction and left shift masked to 32 bits), CUDA tensors launch the
kernel or raise.  Each
launch adds one to ``cuda_kernels.launches["tea_search"]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.runtime import profiling as prof

_DELTA = np.uint32(0x9E3779B9)
_SUM0 = np.uint32((0x9E3779B9 * 32) & 0xFFFFFFFF)
_M32 = 0xFFFFFFFF
# first plaintext bytes of a structured TETRA PDU (_score_bytes)
_TETRA_FIRST = (0x01, 0x02, 0x03, 0x04, 0x05, 0x08, 0x0A, 0x0C, 0x82, 0x83,
                0x07)


def _keys_to_words_tea1(keys: np.ndarray) -> np.ndarray:
    """(K, 10) key bytes -> (K, 5) big-endian uint16 words (as uint32)."""
    k = np.asarray(keys, np.uint8).reshape(-1, 10)
    words = (k[:, 0::2].astype(np.uint32) << 8) | k[:, 1::2]
    return words


def _keys_to_words_tea2(keys: np.ndarray) -> np.ndarray:
    """(K, 16) key bytes -> (K, 4) big-endian uint32 words."""
    k = np.asarray(keys, np.uint8).reshape(-1, 16)
    w = (k[:, 0::4].astype(np.uint32) << 24) \
        | (k[:, 1::4].astype(np.uint32) << 16) \
        | (k[:, 2::4].astype(np.uint32) << 8) \
        | k[:, 3::4].astype(np.uint32)
    return w


def _payload_to_words(payloads: np.ndarray) -> tuple:
    """(B, L) bytes (L % 8 == 0) -> (v0, v1) each (B, L//8) uint32."""
    p = np.asarray(payloads, np.uint8)
    b, length = p.shape
    if length % 8:
        raise ValueError("payload length must be a multiple of 8")
    w = p.reshape(b, length // 8, 2, 4)
    v = ((w[..., 0].astype(np.uint32) << 24)
         | (w[..., 1].astype(np.uint32) << 16)
         | (w[..., 2].astype(np.uint32) << 8)
         | w[..., 3].astype(np.uint32))
    return v[:, :, 0], v[:, :, 1]


# ---------------------------------------------------------------------------
# the kernel: decrypt rounds + plaintext score
# ---------------------------------------------------------------------------

def _rounds_plain(v0, v1, k, tea1: bool) -> tuple:
    """32 decrypt rounds on int64 words in [0, 2^32); ``k`` holds the four
    key-word columns, each broadcastable against v0 / v1."""
    s = int(_SUM0)
    m = _M32
    for _ in range(32):
        if tea1:
            f = ((((v0 << 4) & m) ^ (v0 >> 5) ^ s) + v0) & m
            v1 = (v1 - (f ^ ((k[(s >> 11) & 3] + s) & m))) & m
            s = (s - int(_DELTA)) & m
            f = ((((v1 << 4) & m) ^ (v1 >> 5) ^ s) + v1) & m
            v0 = (v0 - (f ^ ((k[s & 3] + s) & m))) & m
        else:
            f = ((((v0 << 4) & m) + k[2]) & m) ^ ((v0 + s) & m) \
                ^ (((v0 >> 5) + k[3]) & m)
            v1 = (v1 - f) & m
            s = (s - int(_DELTA)) & m
            f = ((((v1 << 4) & m) + k[0]) & m) ^ ((v1 + s) & m) \
                ^ (((v1 >> 5) + k[1]) & m)
            v0 = (v0 - f) & m
    return v0, v1


def _words_to_bytes(p0, p1) -> torch.Tensor:
    """(..., W) int64 word pairs -> (..., W*8) uint8, big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=p0.device)
    b = torch.cat([(p0[..., None] >> shifts) & 0xFF,
                   (p1[..., None] >> shifts) & 0xFF], dim=-1)
    return b.reshape(*b.shape[:-2], -1).to(torch.uint8)


def _score_bytes(plain: torch.Tensor) -> torch.Tensor:
    """(K, B, L) plaintext bytes -> (K, B) int32 plausibility score
    (the reference's printable-ASCII density, non-degenerate bytes and
    structured-header bonus; the JAX _score_bytes)."""
    p = plain.to(torch.int32)
    printable = ((p >= 32) & (p <= 126)).to(torch.int32)
    score = 2 * printable.sum(dim=-1, dtype=torch.int32)
    nonzero = (p != 0).any(dim=-1)
    nonff = (p != 0xFF).any(dim=-1)
    score = score + torch.where(nonzero & nonff, 30, -50)
    first = p[..., 0]
    score = score + torch.where((first != 0) & (first != 0xFF), 10, 0)
    tetra = torch.zeros_like(first, dtype=torch.bool)
    for v in _TETRA_FIRST:
        tetra |= first == v
    score = score + torch.where(tetra, 20, 0)
    return score.to(torch.int32)


def _key_cols(key_words: torch.Tensor, shape: tuple) -> list:
    kw = key_words.to(torch.int64) & _M32
    return [kw[:, j].reshape(shape) for j in range(4)]


def tea_decrypt_plain(v0, v1, key_words, tea1: bool) -> torch.Tensor:
    """Plain version of tea_decrypt."""
    k = _key_cols(key_words, (-1, 1, 1))
    p0, p1 = _rounds_plain(v0.to(torch.int64)[None] & _M32,
                           v1.to(torch.int64)[None] & _M32, k, tea1)
    return _words_to_bytes(p0, p1)


def tea_search_plain(v0, v1, key_words, tea1: bool) -> torch.Tensor:
    """Plain version of tea_search."""
    return _score_bytes(tea_decrypt_plain(v0, v1, key_words, tea1))


def tea_decrypt_pairs_plain(v0, v1, key_words, tea1: bool) -> torch.Tensor:
    """Plain version of tea_decrypt_pairs."""
    k = _key_cols(key_words, (-1, 1))
    p0, p1 = _rounds_plain(v0.to(torch.int64) & _M32,
                           v1.to(torch.int64) & _M32, k, tea1)
    return _words_to_bytes(p0, p1)


def tea_decrypt_fused_plain(v0, v1, kw1, kw2) -> torch.Tensor:
    """Plain version of tea_decrypt_fused: each family's plain version,
    TEA1's keys first."""
    parts = [tea_decrypt_plain(v0, v1, kw, tea1)
             for kw, tea1 in ((kw1, True), (kw2, False)) if kw.shape[0]]
    return torch.cat(parts, dim=0)


TEA_CTA = 256                      # threads a CTA of csrc/tea.cu


def _magic(d: int) -> tuple:
    """(m, s) with n // d == (n + ((n * m) >> 32)) >> s for every
    0 <= n < 2^32 (the round-up method: m + 2^32 = ceil(2^(32+s) / d),
    s = ceil(log2 d)); csrc/tea.cu's fastdiv."""
    s = (d - 1).bit_length()
    return -(-(1 << (32 + s)) // d) - (1 << 32), s


class TeaGrid(NamedTuple):
    """The launch of csrc/tea.cu: TEA1's n1 items in ``ctas1`` CTAs, then
    TEA2's n2 in ``ctas2``; an item is an 8-byte block (modes 0, 2) or a
    (key, payload) pair (mode 1), item i of TEA2 writes output item
    n1 + i, and (pay_m, pay_s), (words_m, words_s) divide by B and W."""
    ctas1: int
    ctas2: int
    n1: int
    n2: int
    n_pay: int
    n_words: int
    pay_m: int
    pay_s: int
    words_m: int
    words_s: int


def tea_grid(mode: int, k1: int, k2: int, n_pay: int,
             n_words: int) -> TeaGrid:
    """The grid of a launch with k1 TEA1 and k2 TEA2 keys (in mode 2 the
    one family's key count is n_pay) over n_pay payloads of n_words
    blocks."""
    per_key = n_words if mode == 2 else n_pay * (1 if mode == 1 else n_words)
    n1, n2 = k1 * per_key, k2 * per_key
    if n1 + n2 >= 1 << 31:
        raise ValueError(f"tea_search: {n1 + n2} items in one launch, "
                         "more than 2^31 - 1")
    return TeaGrid(-(-n1 // TEA_CTA), -(-n2 // TEA_CTA), n1, n2, n_pay,
                   n_words, *_magic(n_pay), *_magic(n_words))


def _tea_launch(mode: int, v0, v1, kw1, kw2, names=("kw1", "kw2")):
    """Check the arguments; on CUDA tensors launch csrc/tea.cu once and
    return its output, on CPU tensors return None (the plain version)."""
    b = v0.shape[0] if v0.dim() == 2 else -1
    w = v0.shape[1] if v0.dim() == 2 else -1
    ck._check(v0, "v0", (b, w), torch.int32)
    ck._check(v1, "v1", (b, w), torch.int32)
    k = [0, 0]
    for f, (kw, n_kw, name) in enumerate(((kw1, 5, names[0]),
                                          (kw2, 4, names[1]))):
        if kw is not None:
            k[f] = kw.shape[0] if kw.dim() == 2 else -1
            ck._check(kw, name, (b if mode == 2 else k[f], n_kw),
                      torch.int32)
    if w < 1 or b < 1 or k[0] + k[1] < 1 or (mode == 2 and all(k)):
        raise ValueError(f"tea_search: {k[0]} TEA1 and {k[1]} TEA2 keys, "
                         f"{b} payloads of {w} blocks")
    grid = tea_grid(mode, k[0], k[1], b, w)
    tensors = [t for t in (v0, v1, kw1, kw2) if t is not None]
    if ck._route(*tensors) == "cpu":
        return None
    dev = v0.device
    lib = ck.build()
    if mode == 1:
        out = torch.empty((k[0] + k[1], b), dtype=torch.int32, device=dev)
    elif mode == 2:
        out = torch.empty((b, 8 * w), dtype=torch.uint8, device=dev)
    else:
        out = torch.empty((k[0] + k[1], b, 8 * w), dtype=torch.uint8,
                          device=dev)
    ck._launch("tea_search", dev, lib.tt_tea,
               *kernel_args(mode, v0, v1, kw1, kw2, out, grid))
    return out


def kernel_args(mode: int, v0, v1, kw1, kw2, out, grid=None) -> tuple:
    """The C entry's arguments but the stream (device pointers, a family
    without keys NULL, and the grid's integers): what ``_tea_launch``
    launches and ``chip_smoke.py`` times alone."""
    if grid is None:
        k = [0 if kw is None else kw.shape[0] for kw in (kw1, kw2)]
        grid = tea_grid(mode, *k, *v0.shape)
    return (mode, ck._ptr(v0), ck._ptr(v1),
            None if kw1 is None else ck._ptr(kw1),
            None if kw2 is None else ck._ptr(kw2), *grid, ck._ptr(out))


def _one_family(key_words, tea1: bool) -> tuple:
    return (key_words, None) if tea1 else (None, key_words)


def tea_decrypt_fused(v0: torch.Tensor, v1: torch.Tensor,
                      kw1: torch.Tensor, kw2: torch.Tensor) -> torch.Tensor:
    """Both cipher families in one launch: (B, W) int32 word pairs, (K1, 5)
    TEA1 and (K2, 4) TEA2/3/4 int32 key words (either may have no rows)
    -> (K1 + K2, B, 8W) uint8 plaintexts, TEA1's keys first, each
    bit-exact vs crypto.tea.TEADecryptor.decrypt (ECB).

    Replaces the reference's ``_decrypt_impl`` (XLA rounds over a
    (K, B, W) uint32 grid), once a family.  Bound: integer operations
    (384 / 320 instructions a TEA1 / TEA2 block).  Design: csrc/tea.cu,
    a thread an 8-byte block, a warp's W-block pairs on adjacent lanes
    (256 contiguous bytes a store), TEA1's blocks padded to whole CTAs and
    TEA2's after them."""
    out = _tea_launch(0, v0, v1, kw1, kw2)
    return tea_decrypt_fused_plain(v0, v1, kw1, kw2) if out is None else out


def tea_decrypt(v0: torch.Tensor, v1: torch.Tensor, key_words: torch.Tensor,
                tea1: bool) -> torch.Tensor:
    """Every key against every payload: (B, W) int32 word pairs (uint32
    bit patterns) and (K, 5 or 4) int32 key words -> (K, B, 8W) uint8
    plaintexts; tea_decrypt_fused for one family."""
    out = _tea_launch(0, v0, v1, *_one_family(key_words, tea1),
                      names=("key_words",) * 2)
    return tea_decrypt_plain(v0, v1, key_words, tea1) if out is None else out


def tea_search(v0: torch.Tensor, v1: torch.Tensor, key_words: torch.Tensor,
               tea1: bool) -> torch.Tensor:
    """Every key against every payload -> (K, B) int32 plaintext scores
    (the reference's ``_score_bytes``), the plaintext kept in registers:
    the same kernel's search mode, a thread a (key, payload) pair; 4 bytes
    out a pair."""
    out = _tea_launch(1, v0, v1, *_one_family(key_words, tea1),
                      names=("key_words",) * 2)
    return tea_search_plain(v0, v1, key_words, tea1) if out is None else out


def tea_decrypt_pairs(v0: torch.Tensor, v1: torch.Tensor,
                      key_words: torch.Tensor, tea1: bool) -> torch.Tensor:
    """Payload b decrypted with key b: (B, W) word pairs and (B, 5 or 4)
    key words -> (B, 8W) uint8.  The same kernel, a thread a block."""
    out = _tea_launch(2, v0, v1, *_one_family(key_words, tea1),
                      names=("key_words",) * 2)
    return (tea_decrypt_pairs_plain(v0, v1, key_words, tea1) if out is None
            else out)


# ---------------------------------------------------------------------------
# public functions (the JAX package's)
# ---------------------------------------------------------------------------

def _pad_rows(v0, v1, mesh, axis: str | None) -> int:
    """Rows to append so the payload axis divides the mesh size — a
    fleet's backlog is an arbitrary count.  Zero rows are harmless for
    ECB; callers slice the results back to the true B."""
    n_dev = mesh.shape[axis or mesh.axis_names[0]]
    return (-v0.shape[0]) % n_dev


def _payload_shards(payloads: np.ndarray, mesh, axis) -> list:
    """[(device, rows)]: the zero-padded payload rows cut into one
    contiguous block for each entry along the mesh axis."""
    pad = _pad_rows(payloads, payloads, mesh, axis)
    rows = np.concatenate(
        [payloads, np.zeros((pad, payloads.shape[1]), np.uint8)])
    devs = mesh.axis_devices(axis)
    per = len(rows) // len(devs)
    return [(d, rows[i * per:(i + 1) * per]) for i, d in enumerate(devs)]


def _key_matrix(keys, length: int) -> np.ndarray:
    """A list of key byte strings or a (K, length) uint8 array -> (K,
    length) uint8."""
    if isinstance(keys, (list, tuple)):
        if not keys:
            return np.zeros((0, length), np.uint8)
        keys = np.stack([np.frombuffer(bytes(k), np.uint8) for k in keys])
    return np.asarray(keys, np.uint8).reshape(-1, length)


def _upload(arrays: list, device) -> list:
    """uint32 arrays -> int32 tensors on the device, from ONE host-to-device
    copy of their concatenation (each a contiguous view of it)."""
    flat = np.concatenate([np.asarray(a, np.uint32).reshape(-1)
                           for a in arrays]).view(np.int32)
    buf = torch.from_numpy(flat).to(resolve(device))
    out, at = [], 0
    for a in arrays:
        n = int(np.prod(a.shape))
        out.append(buf[at:at + n].view(a.shape))
        at += n
    return out


def _device_words(payloads, keys, algorithm: str, device) -> tuple:
    """(v0, v1, key words, tea1, B) as int32 tensors on the device (one
    upload)."""
    payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
    tea1 = algorithm.upper() == "TEA1"
    kw = (_keys_to_words_tea1(_key_matrix(keys, 10)) if tea1
          else _keys_to_words_tea2(_key_matrix(keys, 16)))
    v0, v1, kw = _upload([*_payload_to_words(payloads), kw], device)
    return v0, v1, kw, tea1, payloads.shape[0]


def tea_decrypt_batch(payloads, keys, algorithm: str = "TEA1",
                      device=None, mesh=None,
                      axis: str | None = None) -> np.ndarray:
    """Decrypt every payload with every key on the device.

    payloads: (B, L) uint8 (L % 8 == 0); keys: list/array of key bytes.
    mesh: optional runtime.sharding.Mesh — shards the payload axis over
    ``axis`` (default: the mesh's first axis), a launch on each entry's
    device (``device`` is then not used); results are bit-identical to
    the unsharded call.
    Returns (K, B, L) uint8 plaintexts — bit-exact vs
    crypto.tea.TEADecryptor.decrypt (ECB) for each (key, payload) pair.
    """
    if mesh is not None:
        payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
        parts = [tea_decrypt_batch(rows, keys, algorithm, device=d)
                 for d, rows in _payload_shards(payloads, mesh, axis)]
        return np.concatenate(parts, axis=1)[:, :payloads.shape[0]]
    v0, v1, kw, tea1, _ = _device_words(payloads, keys, algorithm, device)
    return tea_decrypt(v0, v1, kw, tea1).cpu().numpy()


def tea_decrypt_families(payloads, tea1_keys, tea2_keys,
                         device=None) -> np.ndarray:
    """Decrypt every payload with every TEA1 key and every TEA2/3/4 key in
    one device round trip: one upload (payload and both families' key
    words), one launch (tea_decrypt_fused), one fetch (into pinned host
    memory).

    payloads: (B, L) uint8 (L % 8 == 0); tea1_keys: 10-byte keys,
    tea2_keys: 16-byte keys (lists or arrays; either may be empty, not
    both).  Returns (K1 + K2, B, L) uint8, TEA1's keys first.
    """
    payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
    v0, v1, kw1, kw2 = _upload(
        [*_payload_to_words(payloads),
         _keys_to_words_tea1(_key_matrix(tea1_keys, 10)),
         _keys_to_words_tea2(_key_matrix(tea2_keys, 16))], device)
    out = tea_decrypt_fused(v0, v1, kw1, kw2)
    if out.device.type == "cpu":
        return out.numpy()
    # the fetch through a pinned buffer (the caching host allocator keeps
    # it across calls): a direct copy, not staged through pageable memory
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out)
    return host.numpy()


def batch_decrypt_frames(decoders, frames: list, device=None) -> None:
    """Finish deferred decryption for a block's frames with ONE device
    keys x payloads search covering both cipher families.

    Each frame's key plan and selection loop are EXACTLY the host
    _decrypt_frame path (frame.decoder._build_key_plan /
    _select_decrypt); only the TEA rounds move to the device.  Payloads
    are zero-padded to a common width — harmless for ECB, each frame's
    plaintext is truncated back to its own length.

    Traced as ``key_plan`` (plans, key and payload matrices), ``tea``
    (upload, launch, fetch) and ``key_score`` (the selection loops), and
    counted: ``key_frames`` (frames with a plan), ``tea_rows`` (K x B of
    the launch), ``keys_scored`` (plan entries scored through the last
    plaintext each frame's loop asked for, BYPASS entries among them)
    and ``decrypted``.
    """
    with prof.span("key_plan"):
        pending = []
        for f in frames:
            if not f.pop("decryption_pending", False):
                continue
            dec = decoders[f.get("carrier", 0)]
            plan = dec._build_key_plan(f)
            if plan is None:
                continue
            pending.append((f, dec, plan))
    if not pending:
        return
    prof.count("key_frames", len(pending))
    # the last plan entry each frame's loop asked a plaintext for (-1:
    # none): its loop scored entries 0..last
    last = [-1] * len(pending)
    if len(pending) == 1:
        # a lone frame is cheaper on the host than one device round trip
        from tetraear_tpu_torch.crypto.tea import TEADecryptor
        f, dec, (payload, keys_to_try) = pending[0]

        def host_plaintext(i):
            # what _select_decrypt does without plaintext_at, counted
            last[0] = i
            key, _desc, alg = keys_to_try[i]
            return TEADecryptor(key, alg).decrypt(payload)

        with prof.span("key_score"):
            dec._select_decrypt(f, payload, keys_to_try, host_plaintext)
            dec._post_decrypt_sds(f)
        _count_scored(pending, last)
        return

    with prof.span("key_plan"):
        # collect unique keys per cipher family (TEA1 10-byte; TEA2/3/4
        # share the classic-TEA structure, crypto.tea semantics)
        fam_keys = {"TEA1": [], "TEA2": []}
        fam_index = {"TEA1": {}, "TEA2": {}}
        max_len = 0
        for _, _, (payload, keys_to_try) in pending:
            max_len = max(max_len, len(payload))
            for key, _desc, alg in keys_to_try:
                if key is None:
                    continue
                fam = "TEA1" if alg == "TEA1" else "TEA2"
                want = 10 if fam == "TEA1" else 16
                if len(key) != want:
                    continue           # host loop would raise+skip too
                if key not in fam_index[fam]:
                    fam_index[fam][key] = len(fam_keys[fam])
                    fam_keys[fam].append(key)

        payload_mat = np.zeros((len(pending), max_len), np.uint8)
        for bi, (_, _, (payload, _)) in enumerate(pending):
            payload_mat[bi, :len(payload)] = np.frombuffer(payload, np.uint8)

    # one search for both families, TEA1's keys first
    plains = None
    if fam_keys["TEA1"] or fam_keys["TEA2"]:
        with prof.span("tea"):
            plains = tea_decrypt_families(payload_mat, fam_keys["TEA1"],
                                          fam_keys["TEA2"], device=device)
        prof.count("tea_rows", plains.shape[0] * plains.shape[1])
    first = {"TEA1": 0, "TEA2": len(fam_keys["TEA1"])}

    with prof.span("key_score"):
        for bi, (f, dec, (payload, keys_to_try)) in enumerate(pending):

            def plaintext_at(i, _bi=bi, _payload=payload,
                             _keys=keys_to_try):
                last[_bi] = i
                key, _desc, alg = _keys[i]
                fam = "TEA1" if alg == "TEA1" else "TEA2"
                ki = fam_index[fam].get(key)
                if ki is None:         # invalid combo: host semantics
                    from tetraear_tpu_torch.crypto.tea import TEADecryptor
                    return TEADecryptor(key, alg).decrypt(_payload)
                return plains[first[fam] + ki, _bi,
                              :len(_payload)].tobytes()

            dec._select_decrypt(f, payload, keys_to_try, plaintext_at)
            dec._post_decrypt_sds(f)
    _count_scored(pending, last)


def _count_scored(pending: list, last: list) -> None:
    """The block's ``keys_scored`` and ``decrypted`` counters."""
    prof.count("keys_scored", sum(last) + len(last))
    prof.count("decrypted", sum(1 for f, _, _ in pending
                                if f.get("decrypted")))


def tea_key_search(payloads, keys, algorithm: str = "TEA1",
                   device=None, mesh=None, axis: str | None = None) -> dict:
    """Try every key against every payload on the device.

    Args:
        payloads: (B, L) uint8 ciphertext rows, L % 8 == 0 (pad first).
        keys: list of key byte strings (10 bytes for TEA1, 16 for
            TEA2/3/4), or an (K, key_len) uint8 array.
        algorithm: 'TEA1' or 'TEA2'/'TEA3'/'TEA4' (aliases, crypto.py
            semantics).
        mesh: optional runtime.sharding.Mesh — shards the payload axis
            over ``axis`` (default: first mesh axis), a search on each
            entry's device (``device`` is then not used); the scoring
            and argmax are per payload, so the results are
            bit-identical, with no collective.

    Returns dict with:
        scores (K, B) int32, best_key_index (B,) int32 (the first
        maximum over keys, as ``jnp.argmax``), best_score (B,) int32,
        plaintexts (B, L) uint8 — each payload decrypted with its best
        key (a second launch over the B (best key, payload) pairs).
    """
    if mesh is not None:
        payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
        b = payloads.shape[0]
        parts = [tea_key_search(rows, keys, algorithm, device=d)
                 for d, rows in _payload_shards(payloads, mesh, axis)]
        return {"scores": np.concatenate([p["scores"] for p in parts],
                                         axis=1)[:, :b],
                **{k: np.concatenate([p[k] for p in parts])[:b]
                   for k in ("best_key_index", "best_score",
                             "plaintexts")}}
    v0, v1, kw, tea1, _ = _device_words(payloads, keys, algorithm, device)
    scores = tea_search(v0, v1, kw, tea1)
    best_score, _ = scores.max(dim=0)
    best_key = torch.argmax(scores, dim=0)
    plain = tea_decrypt_pairs(v0, v1, kw[best_key].contiguous(), tea1)
    return {
        "scores": scores.cpu().numpy(),
        "best_key_index": best_key.to(torch.int32).cpu().numpy(),
        "best_score": best_score.cpu().numpy(),
        "plaintexts": plain.cpu().numpy(),
    }
