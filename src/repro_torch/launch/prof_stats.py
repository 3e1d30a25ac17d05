"""What one step costs, counted and profiled (the port's counterpart of
``repro.launch.hlo_stats``).

The JAX package walks a compiled HLO module: trip-count-aware dot flops,
collective result bytes and a buffer-write traffic proxy. An eager step has
no module to walk, but it runs every operation of every layer, so counting
the operations as they run needs no trip counts:

- :class:`StepCounter`, a ``TorchDispatchMode`` over one step: the flops of
  every local operation (``torch.utils.flop_counter``'s formulas: matmuls,
  convolutions, attention), the bytes every materialized output writes
  (views and in-place results write none), the result bytes of every
  collective by kind (all-reduce, all-gather, reduce-scatter, all-to-all),
  and the peak of the bytes the step's outputs held alive at once. On a
  mesh a DTensor operation runs local operations on the rank's shards:
  those are what it counts (per rank, the JAX post-SPMD convention). It
  runs under ``FakeTensorMode`` as well, with no allocation (the dry run).
- :func:`profile_step`, ``torch.profiler`` over a step on the card: device
  kernel time, launches per kernel name, the top kernels by time, the busy
  share of the window and ``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVE_KINDS = (
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("permute", "collective-permute"), ("send", "collective-permute"),
)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_nbytes(tree) -> int:
    """Bytes of a tree's tensors as this rank holds them (a DTensor's
    local shard)."""
    from repro_torch.models.sharding_ctx import _is_dtensor

    leaves, _ = tree_flatten(tree)
    return sum(_nbytes(x.to_local() if _is_dtensor(x) else x) for x in leaves if isinstance(x, torch.Tensor))


def _collective_kind(func) -> str:
    ns = func.namespace
    if "c10d" not in ns:
        return ""
    name = func._overloadpacket.__name__
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return ""


def _aliases(func) -> bool:
    """Whether the op's result is a view of, or written into, an input."""
    return any(r.alias_info is not None for r in func._schema.returns)


class StepCounter(TorchDispatchMode):
    """Counts what the operations run under it do; see the module's text."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flop_fns = flop_registry
        self.flops = 0  # local operations (per rank)
        self.bytes_written = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.collective_counts: Dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.argument_bytes = None
        self.output_bytes = None
        self.ops = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor runs the op on the rank's shards, under this mode again
            return NotImplemented
        out = func(*args, **kwargs)
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        self.ops += 1
        kind = _collective_kind(func)
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if kind:
            self.collectives[kind] += sum(_nbytes(t) for t in flat_out)
            self.collective_counts[kind] += 1
            return out
        if not _aliases(func):
            for t in flat_out:
                n = _nbytes(t)
                self.bytes_written += n
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out


def count_step(fn: Callable, *args) -> Tuple[Any, StepCounter]:
    """``fn(*args)`` under a :class:`StepCounter`; the counter also holds
    the arguments' and outputs' bytes."""
    counter = StepCounter()
    counter.argument_bytes = tree_nbytes(args)
    with counter:
        out = fn(*args)
    counter.output_bytes = tree_nbytes(out)
    return out, counter


def profile_step(fn: Callable, *, top: int = 10) -> Dict[str, Any]:
    """One call of ``fn`` on the card under ``torch.profiler``: its device
    kernel time, kernel launches in all and per kernel name, the ``top``
    kernels by time, the busy share of the window (kernel time over the
    synchronized wall time of the call, profiled) and the peak of
    ``torch.cuda.max_memory_allocated`` over the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in kernels)
    by_time: List[Tuple[str, float, int]] = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    return {
        "wall_ms": wall_s * 1e3,
        "kernel_ms": us / 1e3,
        "busy_share": us / 1e3 / (wall_s * 1e3) if wall_s else 0.0,
        "launches": sum(e.count for e in kernels),
        "launches_by_kernel": {e.key: e.count for e in kernels},
        "top_kernels": [{"name": k, "ms": ms, "launches": n} for k, ms, n in by_time[:top]],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
