"""Host-side batching utilities (numpy only; a copy of the parts of
``repro.data.pipeline`` that the port uses).

Besides the per-batch index helpers of the loop engine, this module builds
the *padded fixed-shape* client stack of the vectorized engine: every
client's dataset is cut into ``batch_size`` batches, padded to a common
``(n_batches_max, batch_size)`` grid, and stacked along a leading client
axis. Padding slots point at sample 0 and carry a zero ``sample_valid``
mask, so masked reductions reproduce the ragged originals exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def bucket_size(n: int) -> int:
    """Round a padded step count up to the next power of two (>= 1), so the
    curriculum ramp needs few distinct round shapes; the extra padded steps
    are exact no-ops."""
    return 1 << max(0, int(n) - 1).bit_length()


def make_batches(n: int, batch_size: int, *, drop_remainder: bool = False) -> List[np.ndarray]:
    """Contiguous index batches [0..n), the last one ragged unless
    ``drop_remainder`` drops it. The FL sim scores and sorts these."""
    ids = np.arange(n)
    batches = [ids[i : i + batch_size] for i in range(0, n, batch_size)]
    if drop_remainder and batches and len(batches[-1]) < batch_size:
        batches = batches[:-1]
    return batches


def gather_batch(data: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in data.items()}


def pad_batches(batches: List[np.ndarray], batch_size: int) -> tuple:
    """(n_batches, batch_size) sample ids + f32 valid mask for one client.
    Ragged final batches are padded with sample id 0, masked out."""
    nb = max(1, len(batches))
    ids = np.zeros((nb, batch_size), np.int32)
    valid = np.zeros((nb, batch_size), np.float32)
    for j, b in enumerate(batches):
        ids[j, : len(b)] = b
        valid[j, : len(b)] = 1.0
    return ids, valid


@dataclasses.dataclass
class ClientStack:
    """All clients' data on one padded (C, NB, B, ...) grid.

    ``data`` holds the gathered feature arrays; ``sample_valid`` is the f32
    validity mask; ``n_batches``/``n_samples`` are the true sizes (padding
    batches beyond ``n_batches[c]`` are entirely invalid).
    """

    data: Dict[str, np.ndarray]
    sample_valid: np.ndarray  # (C, NB, B) f32
    n_batches: np.ndarray  # (C,) int
    n_samples: np.ndarray  # (C,) int


def stack_cohort(client_data: Sequence[Dict[str, np.ndarray]], batch_size: int, *,
                 pad_batches_to: Optional[int] = None, pad_clients_to: Optional[int] = None) -> ClientStack:
    """The padded fixed-shape stack of a *cohort* of clients.

    The streaming counterpart of :func:`stack_clients`: callers pass just the
    sampled cohort's shards (any iterable, e.g. fetches from an out-of-core
    client store), so peak memory scales with the cohort, not the
    population. ``pad_batches_to`` pads the batch axis up to a fixed grid
    height (extra rows repeat the client's first batch and are entirely
    invalid, so they are exact no-ops). ``pad_clients_to`` pads the *client*
    axis up to that count with inert rows (client 0's data, all-zero
    ``sample_valid``, zero ``n_batches`` and ``n_samples``), so that the
    stack divides evenly over a client mesh's groups
    (:func:`repro_torch.launch.mesh.num_client_groups`). The padding rows
    come after every real client; training on one is an exact no-op.
    """
    per_client = []
    for cd in client_data:
        n = len(next(iter(cd.values())))
        ids, valid = pad_batches(make_batches(n, batch_size), batch_size)
        per_client.append((cd, n, ids, valid))
    if not per_client:
        raise ValueError("stack_cohort needs at least one client")
    nb_max = max(ids.shape[0] for _, _, ids, _ in per_client)
    if pad_batches_to is not None:
        if pad_batches_to < nb_max:
            raise ValueError(f"pad_batches_to={pad_batches_to} < largest cohort client's {nb_max} batches")
        nb_max = pad_batches_to
    data = {}
    for k in per_client[0][0]:
        stacked = []
        for cd, _, ids, _ in per_client:
            g = cd[k][ids.reshape(-1)].reshape(ids.shape + cd[k].shape[1:])
            if ids.shape[0] < nb_max:
                g = np.concatenate([g, np.repeat(g[:1], nb_max - ids.shape[0], axis=0)], axis=0)
            stacked.append(g)
        data[k] = np.stack(stacked)
    valid = np.zeros((len(per_client), nb_max, batch_size), np.float32)
    for c, (_, _, _, v) in enumerate(per_client):
        valid[c, : v.shape[0]] = v
    n_batches = np.asarray([ids.shape[0] for _, _, ids, _ in per_client])
    n_samples = np.asarray([n for _, n, _, _ in per_client])
    extra = 0 if pad_clients_to is None else pad_clients_to - len(per_client)
    if extra > 0:
        data = {k: np.concatenate([v, np.repeat(v[:1], extra, axis=0)]) for k, v in data.items()}
        valid = np.concatenate([valid, np.zeros((extra,) + valid.shape[1:], np.float32)])
        n_batches = np.concatenate([n_batches, np.zeros(extra, n_batches.dtype)])
        n_samples = np.concatenate([n_samples, np.zeros(extra, n_samples.dtype)])
    return ClientStack(data=data, sample_valid=valid, n_batches=n_batches, n_samples=n_samples)


def stack_clients(client_data: Sequence[Dict[str, np.ndarray]], batch_size: int, *,
                  pad_clients_to: Optional[int] = None) -> ClientStack:
    """The padded fixed-shape stack of the whole population, the vectorized
    and sharded engines' grid; see :func:`stack_cohort` for the per-round
    streaming variant of the out-of-core client store, and for
    ``pad_clients_to``."""
    return stack_cohort(client_data, batch_size, pad_clients_to=pad_clients_to)


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int, *, seed: int = 0,
                   epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled full batches, ``epochs`` passes, each a permutation drawn
    from ``np.random.default_rng(seed)`` (the JAX package's order)."""
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield gather_batch(data, perm[i : i + batch_size])
