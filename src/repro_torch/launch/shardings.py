"""Sharding rules: tree path -> partition spec -> DTensor placements, for
every tree of the system (port of ``repro.launch.shardings``).

Conventions (one pod: ``("data", "model")``; two pods add ``"pod"``):

- batch / client axes -> ``("pod", "data")`` (one FL client group per index)
- tensor parallel -> ``"model"``: attention heads, d_ff, experts (expert
  parallel), SSM heads, vocab
- LoRA follows the base matrix: ``a`` shards its input dim, ``b`` its output
  dim, the rank is tiny and replicated
- the GAL (global) LoRA is replicated over the client axes (its gradient
  all-reduce is the paper's server aggregation); the client-local LoRA
  carries a leading client-group axis sharded over ``("pod", "data")``, so
  it never crosses clients

Divisibility: a shard must tile its dim exactly, so :func:`_fit` drops any
axis that does not divide its dim (mamba2's vocab 50280 -> a replicated
embed) and MoE falls back from expert parallel to tensor parallel within
each expert when E does not divide the model axis (granite's 40 experts).

A spec is a :class:`PartitionSpec`, a tuple with one entry per tensor dim
(None, an axis name, or a tuple of names), entry for entry the JAX
package's. :func:`placements` turns it into the per-mesh-dim placements of
a ``torch.distributed.tensor.DTensor``; the ``shardings_for`` family returns
a tree of those, and :func:`distribute` places a tree by them.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Tuple

from repro_torch.config import ModelConfig
from repro_torch.utils.tree import tree_map, tree_map_with_path_str


def _canonical(entry):
    """An entry as JAX's PartitionSpec keeps it: a list as a tuple, one name
    in a tuple as the name, an empty tuple as None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else (entry[0] if len(entry) == 1 else entry)
    return entry


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _ndim(leaf) -> int:
    return len(_shape(leaf))


# ---------------------------------------------------------------------------
# rule tables (matched against '/'-joined tree paths)
# ---------------------------------------------------------------------------

_MODEL_LAST = lambda nd: P(*([None] * (nd - 1) + ["model"]))  # noqa: E731
_MODEL_SECOND_LAST = lambda nd: P(*([None] * (nd - 2) + ["model", None]))  # noqa: E731
_REPL = lambda nd: P(*([None] * nd))  # noqa: E731


_BASE_RULES = [
    # embeddings / heads
    (r"(^|/)embed$", _MODEL_LAST),
    (r"(^|/)lm_head$", _MODEL_LAST),  # (D, V) shard vocab
    (r"(^|/)cls_head$", _REPL),
    # attention projections (stacked: (L, d_in, d_out))
    (r"/w[qkv]$|/cw[qkv]$", _MODEL_LAST),  # shard heads (out dim)
    (r"/wo$|/cwo$", _MODEL_SECOND_LAST),  # shard heads (in dim)
    (r"/b[qkv]$|/cb[qkv]$", _MODEL_LAST),
    # mlp
    (r"/w_gate$|/w_up$|/w_in$", _MODEL_LAST),
    (r"/w_down$|/w_out$", _MODEL_SECOND_LAST),
    # MoE: experts sharded (expert parallel); router replicated
    (r"/router$", _REPL),
    (r"/e_(gate|up|down)$", lambda nd: P(*([None, "model"] + [None] * (nd - 2)))),
    (r"/s_(gate|up)$", _MODEL_LAST),
    (r"/s_down$", _MODEL_SECOND_LAST),
    # SSM: shard the inner/channel dim
    (r"/in_proj$", _MODEL_LAST),
    (r"/out_proj$", _MODEL_SECOND_LAST),
    (r"/conv_w$", _MODEL_LAST),
    (r"/(A_log|D|dt_bias)$", _MODEL_LAST),
    (r"/gate_norm_w$", _MODEL_LAST),
    # norms & everything else small
    (r".*", _REPL),
]


def base_param_spec(path: str, leaf, model_size: int = 16,
                    moe_token_parallel: bool = False) -> P:
    nd = _ndim(leaf)
    if re.search(r"(^|/)embed$", path):
        # (V, D): shard vocab rows
        return P(*(["model"] + [None] * (nd - 1)))
    if re.search(r"/e_(gate|up|down)$", path) and nd >= 2:
        # expert parallel when E divides the model axis; else tensor parallel
        # within experts (granite's 40 experts on 16-way)
        E = _shape(leaf)[1]
        if E % model_size == 0:
            return P(*([None, "model"] + [None] * (nd - 2)))
        if moe_token_parallel:
            return _REPL(nd)  # replicate tiny experts; tokens shard instead
        if path.endswith("e_down"):
            return P(*([None] * (nd - 2) + ["model", None]))  # shard Fe (in)
        return _MODEL_LAST(nd)  # shard Fe (out)
    for pat, fn in _BASE_RULES:
        if re.search(pat, path):
            return fn(nd)
    return _REPL(nd)


def lora_spec(path: str, leaf, *, client_axis: Optional[Tuple[str, ...]] = None) -> P:
    """LoRA a: (..., d_in, r) shards d_in like the base input; b: (..., r,
    d_out) shards d_out like the base output. With ``client_axis`` a leading
    client-group dim is prepended (the local LoRA)."""
    nd = _ndim(leaf)
    lead = [client_axis] if client_axis else []
    offset = 1 if client_axis else 0
    body = [None] * (nd - offset)

    is_a = path.endswith("/a")
    out_sharded = bool(re.search(r"/(w[qkv]|cw[qkv]|w_gate|w_up|w_in|in_proj|s_gate|s_up)/", path))
    in_sharded = bool(re.search(r"/(wo|cwo|w_down|w_out|out_proj|s_down)/", path))
    if is_a and in_sharded and nd - offset >= 2:
        body[-2] = "model"  # a: (..., d_in, r) with d_in sharded
    if (not is_a) and out_sharded and nd - offset >= 1:
        body[-1] = "model"  # b: (..., r, d_out) with d_out sharded
    return P(*(lead + body))


def batch_spec(path: str, leaf, dp: Tuple[str, ...], dp_size: int = 1) -> P:
    nd = _ndim(leaf)
    if dp_size > 1 and _shape(leaf)[0] % dp_size:
        return P(*([None] * nd))  # e.g. long_500k's global_batch=1: replicate
    return P(*([dp] + [None] * (nd - 1)))


def cache_spec(path: str, leaf, dp: Tuple[str, ...], cfg: ModelConfig,
               dp_size: int = 1) -> P:
    """KV/SSM caches: (L, B, T, KVH, hd) etc: batch on dp, heads on model
    when divisible, else the time axis on model."""
    nd = _ndim(leaf)
    shape = _shape(leaf)
    spec = [None] * nd
    if nd >= 2 and (dp_size <= 1 or shape[1] % dp_size == 0):
        spec[1] = dp  # batch axis
    if re.search(r"(attn_k|attn_v|^k$|^v$|/k$|/v$|cross_k|cross_v)", path) and nd == 5:
        kvh = shape[3]
        if kvh % 16 == 0:
            spec[3] = "model"
        else:
            spec[2] = "model"  # shard the cache length instead
    elif re.search(r"conv$|conv", path) and nd == 4:
        spec[3] = "model"  # conv channels
    elif re.search(r"state", path) and nd == 5:
        spec[2] = "model"  # SSM heads
    return P(*spec)


# ---------------------------------------------------------------------------
# meshes, specs and placements
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> Mapping[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``; a mapping (a stand-in
    mesh, as the tests pass) as it is."""
    if isinstance(mesh, Mapping):
        return mesh
    names = mesh.mesh_dim_names or ()
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _fit(spec: P, leaf, mesh) -> P:
    """Drop per-dim axes whose size does not divide the dim (a shard must
    tile its dim exactly; e.g. mamba2's vocab 50280 on 16-way)."""
    sizes = mesh_shape(mesh)
    shape = _shape(leaf)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if dim < len(shape) and shape[dim] % prod == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def _restrict(spec: P, mesh) -> P:
    """Drop axis names that do not exist in this mesh (e.g. 'pod' on one pod)."""
    names = set(mesh_shape(mesh))

    def ok(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*[ok(e) for e in spec])


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    mesh dim named by a tensor dim's entry shards that dim, the others
    replicate. An entry ``("pod", "data")`` on one tensor dim shards it on
    both mesh dims, pod-major, as the JAX package's mesh does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [None] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if out[names.index(a)] is not None:  # JAX's NamedSharding refuses it too
                raise ValueError(f"mesh axis {a!r} named twice in {spec}")
            out[names.index(a)] = Shard(dim)
    return tuple(Replicate() if p is None else p for p in out)


# ---------------------------------------------------------------------------
# tree builders: trees of placements
# ---------------------------------------------------------------------------


def shardings_for(mesh, tree, spec_fn) -> Any:
    def mk(path, leaf):
        return placements(_fit(_restrict(spec_fn(path, leaf), mesh), leaf, mesh), mesh)

    return tree_map_with_path_str(mk, tree)


def base_param_shardings(mesh, params, *, moe_token_parallel: bool = False):
    ms = mesh_shape(mesh).get("model", 1)
    return shardings_for(mesh, params, lambda p, l: base_param_spec(p, l, ms, moe_token_parallel))


def lora_shardings(mesh, lora, *, client_axes=None):
    return shardings_for(mesh, lora, lambda p, l: lora_spec(p, l, client_axis=client_axes))


def _dp_size(mesh, dp) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in dp:
        n *= sizes[a]
    return n


def batch_shardings(mesh, batch, dp):
    n = _dp_size(mesh, dp)
    return shardings_for(mesh, batch, lambda p, l: batch_spec(p, l, dp, n))


def cache_shardings(mesh, cache, dp, cfg):
    n = _dp_size(mesh, dp)
    return shardings_for(mesh, cache, lambda p, l: cache_spec(p, l, dp, cfg, n))


def replicated(mesh, tree):
    return shardings_for(mesh, tree, lambda p, l: P())


def distribute(tree, mesh, placements_tree):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its placements.
    Every rank passes the same full leaves and keeps its own shard: no data
    moves (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, pl: distribute_tensor(x, mesh, list(pl), src_data_rank=None), tree, placements_tree)
