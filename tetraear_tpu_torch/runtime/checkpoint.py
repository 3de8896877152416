"""Streaming-state checkpoint/resume (tetraear_tpu/runtime/checkpoint.py).

The carried demod state (NCO cycles, filter halos, timing phase,
previous symbols, the fused path's bit tail) is a tree of dicts and
lists of tensors, so a checkpoint is a flat .npz; restoring it resumes a
stream mid-capture with zero warm-up loss.

The layout is the JAX package's: ``leaf_<i>`` in ``jax.tree_util``'s
flatten order (dict keys sorted, lists in order), ``__treedef__``,
``__extra__`` (JSON) and ``aux_<name>``.  The port's state trees carry
the JAX keys, so a checkpoint's leaves line up one to one across the two
packages.  The structure string is the one ``jax.tree_util`` prints for
the same tree (``str(PyTreeDef)``), so a file of either package restores
into the other's Pipeline of the same configuration; ``restore_into``
compares it, and checks leaf count, shapes and dtypes.

``parser_state`` / ``restore_parser`` carry a frame-layer MAC parser's
state (network identity, the open fragment chain) as JSON values, for
the ``__extra__`` entry ``parsers`` of ``api.Pipeline.save_checkpoint``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

def _flatten(state) -> tuple:
    """(leaves, structure string) in jax.tree_util's order; the string is
    str() of the PyTreeDef jax.tree_util makes of the same tree (the
    port's state trees hold dicts and lists of tensors only)."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(state)})"


def _unflatten(template, leaves: list):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it)

    return walk(template)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path, state, extra: dict | None = None,
               aux: dict | None = None) -> None:
    """aux: named numpy arrays saved alongside the state tree (host
    tails, bit tails, ...) — optional pieces whose presence can vary by
    configuration, so they stay out of the validated structure."""
    leaves, structure = _flatten(state)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    if extra:
        arrays["__extra__"] = np.frombuffer(
            json.dumps(extra, default=str).encode(), dtype=np.uint8)
    for k, v in (aux or {}).items():
        arrays[f"aux_{k}"] = _numpy(v)
    np.savez(path, **arrays)


def load_state(path) -> tuple:
    """Returns (state_leaves_as_list, extra_dict, aux_dict).

    Leaves come back in flatten order; the caller's current state
    template is used to unflatten.  The saved structure string travels
    along as ``extra['__treedef__']`` (a JAX ``PyTreeDef`` string in a
    file the JAX package wrote)."""
    data = np.load(path, allow_pickle=False)
    leaves = []
    i = 0
    while f"leaf_{i}" in data:
        leaves.append(data[f"leaf_{i}"])
        i += 1
    extra = {}
    if "__extra__" in data:
        extra = json.loads(bytes(data["__extra__"]).decode())
    if "__treedef__" in data:
        extra["__treedef__"] = bytes(data["__treedef__"]).decode()
    aux = {k[4:]: data[k] for k in data.files if k.startswith("aux_")}
    return leaves, extra, aux


def restore_into(template, leaves, saved_treedef: str | None = None):
    """Unflatten checkpoint leaves into the template's tree structure,
    each leaf a tensor on its template leaf's device.

    Validates leaf count, the saved structure string and per-leaf
    shapes/dtypes against the template, so
    a checkpoint from a differently-configured pipeline fails with a
    descriptive error instead of mis-restoring state."""
    flat, structure = _flatten(template)
    if len(flat) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, pipeline state has "
            f"{len(flat)} — configuration mismatch")
    if saved_treedef is not None and saved_treedef != structure:
        raise ValueError(
            "checkpoint tree structure does not match this pipeline "
            f"configuration:\n  saved:    {saved_treedef}\n"
            f"  expected: {structure}")
    out = []
    for i, (tmpl, leaf) in enumerate(zip(flat, leaves)):
        l = np.asarray(leaf)
        t_dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
        if tuple(tmpl.shape) != l.shape or t_dtype != l.dtype:
            raise ValueError(
                f"checkpoint leaf {i}: saved {l.dtype}{list(l.shape)} vs "
                f"expected {t_dtype}{list(tmpl.shape)} — configuration "
                "mismatch (carrier count / frontend / block size differ?)")
        out.append(torch.from_numpy(np.array(l, copy=True)).to(tmpl.device))
    return _unflatten(template, out)


_IDENTITY = ("mcc", "mnc", "la", "colour_code")


def _int(v):
    return None if v is None else int(v)


def parser_state(parser) -> dict | None:
    """A frame.mac.MacParser's carried state as JSON values (network
    identity, the fragment buffer as hex and its metadata); None for a
    parser still in its initial state."""
    meta = parser.fragment_metadata
    st = {k: _int(getattr(parser, k)) for k in _IDENTITY}
    st["fragment"] = bytes(parser.fragment_buffer).hex()
    st["fragment_metadata"] = ({"address": _int(meta.get("address")),
                                "encrypted": bool(meta.get("encrypted")),
                                "mode": int(meta.get("mode", 0))}
                               if meta else {})
    if all(st[k] is None for k in _IDENTITY) and not st["fragment"] \
            and not meta:
        return None
    return st


def restore_parser(parser, state: dict) -> None:
    """Inverse of ``parser_state``."""
    for k in _IDENTITY:
        setattr(parser, k, state[k])
    parser.fragment_buffer = bytearray.fromhex(state["fragment"])
    parser.fragment_metadata = dict(state["fragment_metadata"])
