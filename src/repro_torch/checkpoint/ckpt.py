"""Flat-npz tree checkpointing (port of ``repro.checkpoint.ckpt``).

Trees are flattened to ``path/to/leaf`` keys; dtypes and shapes round-trip
exactly. Writes are atomic (tmp + rename), so a crashed run never leaves a
half-written checkpoint behind. ``save_tree``/``load_tree`` are the generic
single-file primitives; ``save_checkpoint``/``load_checkpoint`` layer the
``ckpt_<step>.npz`` naming + GC convention on top. The same primitives back
the out-of-core client store (``repro_torch.federated.store``), which spills
one npz per cold client.

The file format is the JAX package's, so either side reads the other's
files. A leaf may be a tensor (on any device: it is moved to the host to be
written), a numpy array or a Python scalar; :func:`load_tree` returns CPU
tensors, each in storage of its own. numpy has no bfloat16 of its own: a
bfloat16 tensor is written as its 2-byte bit pattern with ``"bfloat16"`` in
the dtype manifest, and read back through those bits, whether they arrive as
``uint16`` (this module's) or as the opaque ``V2`` that numpy writes for the
JAX package's ``ml_dtypes`` arrays.

A hard crash (SIGKILL mid-write) can strand a ``*.tmp`` file; writers never
pick those up, and ``clean_stale_tmp`` sweeps them on the next open.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import flatten_dict, unflatten_dict


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be decoded (truncated/partial
    write, e.g. a crash that outran the tmp+rename protocol on a non-atomic
    filesystem). Raised instead of the underlying zip/npz error so callers
    fail loudly with the offending path — never a silently wrong tree."""


_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")

# Reserved npz entry recording each leaf's dtype name (numpy's names, and
# "bfloat16"): without it a bf16 leaf would reload as raw 2-byte words.
_DTYPE_MANIFEST = "__repro_dtype_manifest__"
_BF16 = "bfloat16"


def _host_array(leaf: Any):
    """``(numpy array, dtype name)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _tensor(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    """A CPU tensor of its own holding ``arr`` as the manifest's dtype."""
    if want == _BF16:
        return torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(torch.bfloat16)
    if want is not None and arr.dtype.name != want:
        arr = arr.view(np.dtype(want))
    return torch.from_numpy(np.array(arr, copy=True))


def save_tree(path: str, tree: Any) -> str:
    """Atomically write a nested-dict tree to ``path`` as flat npz.

    The write goes to a same-directory ``*.tmp`` file first and is renamed
    into place, so readers only ever see complete files. Empty trees are
    valid (they produce an npz with no entries). Returns ``path``.
    """
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    arrays, manifest = {}, {}
    for k, v in flatten_dict(tree).items():
        arrays[k], manifest[k] = _host_array(v)
    arrays[_DTYPE_MANIFEST] = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode("utf-8"), dtype=np.uint8
    )
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_tree(path: str) -> Dict[str, Any]:
    """Load a flat-npz tree written by :func:`save_tree` (or by the JAX
    package's) as a nested dict of CPU tensors.

    Raises :class:`CorruptCheckpointError` when the file exists but is not a
    readable npz (truncated zip directory, clipped entry, bad CRC) — a
    partial write must never decode to a zero-filled or shortened tree.
    A missing file still raises the plain ``FileNotFoundError``.
    """
    try:
        with np.load(path) as data:
            manifest = {}
            if _DTYPE_MANIFEST in data.files:
                manifest = json.loads(bytes(data[_DTYPE_MANIFEST]).decode("utf-8"))
            flat = {k: _tensor(data[k], manifest.get(k)) for k in data.files if k != _DTYPE_MANIFEST}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError, KeyError, TypeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint file {path!r} is unreadable ({type(e).__name__}: {e});"
            " likely a partial write — restore from an older checkpoint"
        ) from e
    return unflatten_dict(flat)


def clean_stale_tmp(directory: str) -> int:
    """Remove ``*.tmp`` leftovers from a crashed writer. Returns count removed.

    Live writers hold their tmp file only for the duration of one
    ``save_tree`` call, so this is safe to run whenever no save is in
    flight (e.g. when (re)opening a checkpoint directory or store).
    """
    if not os.path.isdir(directory):
        return 0
    removed = 0
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            try:
                os.unlink(os.path.join(directory, name))
                removed += 1
            except OSError:  # pragma: no cover - racing unlink
                pass
    return removed


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Save ``tree`` (nested dict of arrays) as ckpt_<step>.npz. Returns path.

    Also sweeps ``*.tmp`` strays from a previously crashed writer — the
    checkpoint convention is single-writer, so the next save is the natural
    point to reclaim the space.
    """
    clean_stale_tmp(directory)
    path = save_tree(os.path.join(directory, f"ckpt_{step}.npz"), tree)
    _gc(directory, keep)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return load_tree(path)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best


def _gc(directory: str, keep: int) -> None:
    ckpts = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            ckpts.append((int(m.group(1)), name))
    for _, name in sorted(ckpts)[:-keep]:
        os.unlink(os.path.join(directory, name))
