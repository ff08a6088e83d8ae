"""Checkpointing: parameter, optimizer and FL-round state to disk and
back, port of ``repro.ckpt.checkpoint``.

The on-disk format is the JAX package's, so a checkpoint written by one
package loads in the other: one ``.npz`` whose keys are the tree paths
joined by ``"/"`` (dict keys in sorted order, list and tuple indices, a
NamedTuple field as ``.name``, as ``jax.tree_util`` names them), a
QTensor leaf as ``<path>.q`` and ``<path>.scales`` with its metadata in
the manifest, and the JSON manifest beside it (``<path>.json``). Both
files are written atomically (a temporary file, then a rename). A bf16
leaf is stored as its 2-byte pattern (``uint16``) under the manifest's
dtype ``"bfloat16"`` and read back into ``torch.bfloat16``: numpy has no
bf16 of its own, and the JAX package's (``ml_dtypes``, read back as a
2-byte void array) is not needed to read either kind.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.quant import QTensor

_SEP = "/"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _children(node):
    """``(key, child)`` pairs of an inner node in ``jax.tree_util``'s
    order and naming, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield _SEP.join(prefix), tree
        return
    for k, v in kids:
        yield from _paths(v, prefix + (k,))


def _rebuild(like, leaves: Dict[str, Any], prefix=()):
    kids = _children(like)
    if kids is None:
        return leaves[_SEP.join(prefix)]
    vals = [_rebuild(v, leaves, prefix + (k,)) for k, v in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    a = np.array(a, order="C")            # a writable copy, 0-d kept 0-d
    if dtype_name == "bfloat16":
        bits = a.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"qtensors": {}, "dtypes": {}}
    paths = []
    for key, leaf in _paths(tree):
        paths.append(key)
        if isinstance(leaf, QTensor):
            arrays[key + ".q"] = _to_numpy(leaf.q)
            arrays[key + ".scales"] = _to_numpy(leaf.scales)
            meta["qtensors"][key] = {
                "bits": leaf.bits, "mode": leaf.mode, "block": leaf.block,
                "orig_shape": list(leaf.orig_shape),
                "out_dtype": _dtype_name(leaf.out_dtype)}
        else:
            arrays[key] = _to_numpy(leaf)
            meta["dtypes"][key] = _dtype_name(leaf.dtype)
    meta["treedef"] = f"repro_torch tree of {len(paths)} leaves"
    meta["paths"] = paths
    return arrays, meta


def save_checkpoint(path: str, tree, *, extra: dict | None = None) -> None:
    """Atomically write ``tree`` (+ JSON-serializable ``extra``) to
    ``path`` (a .npz file; a sibling .json holds the manifest)."""
    arrays, meta = _flatten(tree)
    if extra:
        meta["extra"] = extra
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    mtmp = path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, path + ".json")


def load_checkpoint(path: str, like) -> Tuple[Any, dict]:
    """Restore a tree with the structure of ``like``, each leaf on the
    device of ``like``'s leaf, in the dtype it was saved with. Returns
    (tree, extra); a leaf whose shape differs from ``like``'s raises
    ValueError."""
    with open(path + ".json") as f:
        meta = json.load(f)
    leaves = {}
    with np.load(path) as data:
        for key, leaf in _paths(like):
            if isinstance(leaf, QTensor):
                qm = meta["qtensors"][key]
                dev = leaf.q.device
                leaves[key] = QTensor(
                    q=_from_numpy(data[key + ".q"], "", dev),
                    scales=_from_numpy(data[key + ".scales"], "", dev),
                    bits=qm["bits"], mode=qm["mode"], block=qm["block"],
                    out_dtype=_DTYPES[qm["out_dtype"]],
                    orig_shape=tuple(qm["orig_shape"]))
                continue
            a = data[key]
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {key}: shape {a.shape} != "
                    f"{tuple(leaf.shape)}")
            leaves[key] = _from_numpy(a, meta["dtypes"].get(key, ""),
                                      leaf.device)
    return _rebuild(like, leaves), meta.get("extra", {})


# ------------------------------------------------------------- FL state
def save_fl_state(path: str, *, round_idx: int, global_trainable,
                  client_sizes, opt_state=None) -> None:
    tree = {"trainable": global_trainable}
    if opt_state is not None:
        tree["opt"] = opt_state
    save_checkpoint(path, tree, extra={
        "round": int(round_idx),
        "client_sizes": [int(c) for c in client_sizes]})


def restore_fl_state(path: str, *, like_trainable, like_opt=None):
    """``(trainable, opt_state or None, round, client_sizes)`` from a
    :func:`save_fl_state` file."""
    like = {"trainable": like_trainable}
    if like_opt is not None:
        like["opt"] = like_opt
    tree, extra = load_checkpoint(path, like)
    return (tree["trainable"], tree.get("opt"), int(extra["round"]),
            extra["client_sizes"])
