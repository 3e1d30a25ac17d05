"""Crash-consistent whole-federation run checkpoints (port of
``repro.checkpoint.federation``; the layout is the JAX package's, so a
snapshot of either restores into the other's runner).

A run checkpoint is one directory per snapshot, ``round_<NNNNNNNN>/``,
holding everything a :class:`repro_torch.core.fibecfed.FibecFed` runner (and
the service wrapped around it) needs to resume as if the process had never died:

* ``arrays.npz`` — every array of run state (global LoRA, per-client or
  stacked LoRA/optimizer/mask/EF-residual trees, curriculum metadata, the
  async scheduler's pending payloads) in one :func:`save_tree` file, dtype
  manifest included;
* ``store/`` — the out-of-core client store's cold files, captured by
  hardlink (copy fallback). ``save_tree``'s tmp+rename protocol never
  mutates an existing inode, so a link taken at snapshot time stays frozen
  while the live store keeps spilling;
* ``MANIFEST.json`` — all JSON-able host state (round counter, RNG states,
  comm accounting, scheduler clocks/EMAs/heap metadata, service extras),
  written **last** via tmp+rename.

The manifest doubles as the commit record: a directory without one is a
partial write — :func:`latest_run_checkpoint` ignores it and the next
:func:`save_run_checkpoint` sweeps it. A crash at any point therefore
either leaves the previous checkpoints untouched or adds one complete new
snapshot; there is no in-between state a reader can observe.

Restore is :func:`restore_runner`: load the manifest + arrays, hand both to
``runner.restore_state`` (which also rematerializes the store from
``store/``), return the service-level extras. A truncated manifest or npz
raises :class:`CorruptCheckpointError` — never a silently wrong tree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import (
    CorruptCheckpointError,
    clean_stale_tmp,
    load_tree,
    save_tree,
)

MANIFEST_NAME = "MANIFEST.json"
ARRAYS_NAME = "arrays.npz"
STORE_DIR = "store"

_ROUND_RE = re.compile(r"round_(\d{8})$")


def _json_default(o: Any):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"not JSON-serializable in a run manifest: {type(o)!r}")


def _write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """Atomically write the manifest — the checkpoint's commit point.

    Module-level on purpose: the fault-injection harness patches this to
    simulate a crash that kills the process after the arrays and store
    files land but before the snapshot commits.
    """
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, sort_keys=True, default=_json_default)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _is_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def _sweep_partial(directory: str) -> int:
    """Delete ``round_*`` directories that never committed (no manifest).

    Run by the next save — the single-writer convention's natural point to
    reclaim a crashed writer's debris. Returns the number swept.
    """
    if not os.path.isdir(directory):
        return 0
    swept = 0
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if _ROUND_RE.match(name) and os.path.isdir(path) and not _is_complete(path):
            shutil.rmtree(path, ignore_errors=True)
            swept += 1
    return swept


def _gc(directory: str, keep: int) -> None:
    complete = []
    for name in os.listdir(directory):
        m = _ROUND_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.isdir(path) and _is_complete(path):
            complete.append((int(m.group(1)), path))
    for _, path in sorted(complete)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def save_run_checkpoint(
    directory: str,
    runner: Any,
    next_round: int,
    *,
    keep: int = 3,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Snapshot ``runner`` as ``<directory>/round_<next_round>/``.

    ``next_round`` is the first round the resumed run will execute — state
    *after* round ``next_round - 1`` merged. ``extra`` carries JSON-able
    service-level state (history, schedule) back out of
    :func:`restore_runner` untouched. Keeps the newest ``keep`` complete
    snapshots; sweeps partial directories and stale tmp files first.

    A sharded runner's ``checkpoint_state`` is a collective: every rank
    calls this, only the runner's ``checkpoint_writer`` (rank 0) touches the
    directory, and every rank returns after its ``checkpoint_barrier``, when
    the snapshot is complete.
    """
    writer = getattr(runner, "checkpoint_writer", True)
    path = os.path.join(directory, f"round_{next_round:08d}")
    if writer:
        os.makedirs(directory, exist_ok=True)
        _sweep_partial(directory)
        clean_stale_tmp(directory)
        if os.path.isdir(path):
            # re-save of an existing round (e.g. an explicit checkpoint()
            # after a periodic one): drop the old snapshot first so a crash
            # mid-write leaves an obvious partial, not a hybrid of two
            shutil.rmtree(path)
        os.makedirs(path)
    host, arrays, files = runner.checkpoint_state()
    if writer:
        _write_snapshot(directory, path, next_round, host, arrays, files, keep, extra)
    barrier = getattr(runner, "checkpoint_barrier", None)
    if barrier is not None:
        barrier()
    return path


def _write_snapshot(directory, path, next_round, host, arrays, files, keep, extra) -> None:
    save_tree(os.path.join(path, ARRAYS_NAME), arrays)
    if files:
        store_dir = os.path.join(path, STORE_DIR)
        os.makedirs(store_dir)
        for name, src in files.items():
            dst = os.path.join(store_dir, name)
            try:
                os.link(src, dst)
            except OSError:  # cross-device or no-hardlink filesystem
                shutil.copyfile(src, dst)
    manifest = {
        "format": 1,
        "next_round": int(next_round),
        "runner": host,
        "extra": dict(extra or {}),
        "store_files": sorted(files),
    }
    _write_manifest(os.path.join(path, MANIFEST_NAME), manifest)
    _gc(directory, keep)


def latest_run_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest *complete* snapshot in ``directory`` (or None).

    Partial directories (no manifest — the writer died before the commit
    point) are skipped, never loaded.
    """
    if not os.path.isdir(directory):
        return None
    best, best_round = None, -1
    for name in os.listdir(directory):
        m = _ROUND_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.isdir(path) and _is_complete(path):
            if int(m.group(1)) > best_round:
                best, best_round = path, int(m.group(1))
    return best


def load_run_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(manifest, arrays)`` of one snapshot directory.

    Raises :class:`CorruptCheckpointError` on a truncated manifest or npz
    (and ``FileNotFoundError`` if the snapshot does not exist at all).
    """
    manifest_path = os.path.join(path, MANIFEST_NAME)
    try:
        with open(manifest_path, "r") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CorruptCheckpointError(
            f"run manifest {manifest_path!r} is unreadable "
            f"({type(e).__name__}: {e}); likely a partial write"
        ) from e
    if manifest.get("format") != 1:
        raise CorruptCheckpointError(
            f"run manifest {manifest_path!r} has unknown format "
            f"{manifest.get('format')!r}"
        )
    arrays = load_tree(os.path.join(path, ARRAYS_NAME))
    return manifest, arrays


def restore_runner(runner: Any, path: str) -> Dict[str, Any]:
    """Restore ``runner`` in place from snapshot ``path``; return the extras.

    The runner must be freshly constructed with the same configuration the
    snapshot was taken under (``restore_state`` validates the basics).
    """
    manifest, arrays = load_run_checkpoint(path)
    runner.restore_state(
        manifest["runner"],
        arrays,
        store_files_dir=os.path.join(path, STORE_DIR),
    )
    return manifest.get("extra", {})
