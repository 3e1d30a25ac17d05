"""The port's fault-tolerant federation service: kill/resume must equal
uninterrupted, and a snapshot crosses frameworks both ways.

The tiny-lm world of ``tests/test_service.py`` (FibecFed/AdamW, seed 7, 4
rounds; the async engine under the dropout scenario with buffer 2 and 3
clients in flight, so every snapshot holds a scheduler with events on its
heap). Four parts:

- the kill/resume matrix of ``tests/test_service.py``, port against port:
  a service-driven run is killed at an injected fault point (pre-round,
  post-round before the checkpoint, the manifest commit, a store spill or
  flush, between dispatch and merge), a fresh runner resumes from the
  checkpoint directory, and the resumed run must reproduce the
  uninterrupted one with JAX's equalities: bit for bit global LoRA, losses
  and comm bytes on the sync engines; on async the LoRA at atol 5e-5 /
  rtol 1e-4 with identical accounting. The fault harness below is the twin
  of ``tests/faults.py``, patching the port's seams;
- ``ckpt_every=0`` is an exact no-op, and checkpointing every round does
  not perturb a run;
- two federations share one service round-robin;
- across frameworks, for loop, vectorized, async and vectorized out of
  core: a JAX runner's snapshot (cold files included) restored into a port
  runner built from the JAX runner's params and initial LoRA continues to
  match JAX's uninterrupted run, and a port snapshot restored into a fresh
  JAX runner does too, at the slice tolerances (losses rel 1e-4 / abs 1e-5,
  LoRA atol 5e-5 / rtol 1e-4; comm bytes and async accounting identical);
  the two snapshots of one run hold the same keys, shapes and dtype names.

The uninterrupted port runs are cached per (engine, store kind), the JAX
runs per engine.
"""
import contextlib
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np

from repro.checkpoint import federation as j_fedckpt
from repro.config import FibecFedConfig, ModelConfig
from repro.data import dirichlet_partition, make_keyword_task
import repro.federated as jfed
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
import repro_torch.federated as tfed
from repro_torch.checkpoint import federation as fedckpt
from repro_torch.convert import to_numpy
from repro_torch.federated.async_agg import AsyncScheduler
from repro_torch.federated.service import COMPLETED, FederationService
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)
ROUNDS = 4
ASYNC_CFG = dict(buffer_size=2, concurrency=3)
ASYNC_STATS = ("virtual_time", "staleness_mean", "merged_clients", "dropped_clients", "stale_dropped",
               "buffer_size")


# -- the fault harness (the twin of tests/faults.py) -------------------------


class InjectedCrash(RuntimeError):
    """The simulated process kill. Never caught by production code."""


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """Crash on the ``at``-th call of ``target``, before or after it runs."""

    name: str
    target: str  # "runner:attr" | "scheduler:attr" | "store:attr" | "ckpt:manifest"
    at: int = 1
    before: bool = True


@contextlib.contextmanager
def install(fault, runner):
    """Arm ``fault`` against ``runner``'s stack; yields a dict whose
    ``fired`` flag records whether the crash triggered."""
    kind, _, attr = fault.target.partition(":")
    state = {"calls": 0, "fired": False}

    def wrap(orig):
        def wrapper(*args, **kwargs):
            state["calls"] += 1
            hit = state["calls"] == fault.at
            if hit and fault.before:
                state["fired"] = True
                raise InjectedCrash(fault.name)
            out = orig(*args, **kwargs)
            if hit and not fault.before:
                state["fired"] = True
                raise InjectedCrash(fault.name)
            return out

        return wrapper

    if kind == "runner":
        setattr(runner, attr, wrap(getattr(runner, attr)))
        try:
            yield state
        finally:
            delattr(runner, attr)  # un-shadow the bound class method
    elif kind == "scheduler":
        orig = getattr(AsyncScheduler, attr)
        setattr(AsyncScheduler, attr, wrap(orig))
        try:
            yield state
        finally:
            setattr(AsyncScheduler, attr, orig)
    elif kind == "store":
        setattr(runner.store, attr, wrap(getattr(runner.store, attr)))
        try:
            yield state
        finally:
            delattr(runner.store, attr)
    elif kind == "ckpt" and attr == "manifest":
        orig = fedckpt._write_manifest
        fedckpt._write_manifest = wrap(orig)
        try:
            yield state
        finally:
            fedckpt._write_manifest = orig
    else:
        raise ValueError(f"unknown fault target {fault.target!r}")


def kill_and_resume(build_runner, *, rounds, ckpt_dir, fault, ckpt_every=1, name="fed"):
    """Run under the service until ``fault`` kills it, then resume a fresh
    runner from disk and finish. Returns ``(runner, federation)`` of the
    resumed life; asserts the fault fired."""
    runner = build_runner()
    svc = FederationService()
    svc.launch(name, runner, rounds=rounds, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    with install(fault, runner) as state:
        try:
            svc.run()
            crashed = False
        except InjectedCrash:
            crashed = True
    assert state["fired"] and crashed, (
        f"fault {fault.name!r} ({fault.target} @ call {fault.at}) never fired after {state['calls']} calls")
    runner2 = build_runner()
    svc2 = FederationService()
    fed2 = svc2.launch(name, runner2, rounds=rounds, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=True)
    svc2.run()
    assert fed2.state == COMPLETED
    return runner2, fed2


# -- worlds and runs ----------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    return dict(model=model, loss_fn=make_loss_fn(model), t_model=t_model, t_loss_fn=t_make_loss_fn(t_model),
                client_data=client_data)


def _factory(world, engine, store_kind, workdir, ref=None):
    """Port runner factory: every call is a "fresh process" (a new runner
    and, out of core, a fresh store directory). ``ref``: start from a JAX
    runner's params and initial LoRA, else from the port's seeded init."""
    counter = {"n": 0}

    def build():
        counter["n"] += 1
        store = None
        if store_kind == "ooc":
            store = tfed.OutOfCoreStore(os.path.join(workdir, f"store{counter['n']}"), hot_slots=2)
        kw = dict(scenario="dropout", async_cfg=tfed.AsyncAggConfig(**ASYNC_CFG)) if engine == "async" else {}
        if ref is not None:
            kw.update(init_params=jax.tree.map(np.asarray, ref.params),
                      init_lora=jax.tree.map(np.asarray, ref._init_lora))
        return tfed.make_runner("fibecfed", world["t_model"], world["t_loss_fn"],
                                tconfig.FibecFedConfig(**dataclasses.asdict(FL)), world["client_data"],
                                optimizer="adamw", engine=engine, seed=7, device="cpu", store=store, **kw)

    return build


def _jax_factory(world, engine, store_kind, workdir):
    counter = {"n": 0}

    def build():
        counter["n"] += 1
        store = None
        if store_kind == "ooc":
            store = jfed.OutOfCoreStore(os.path.join(workdir, f"jstore{counter['n']}"), hot_slots=2)
        kw = dict(scenario="dropout", async_cfg=jfed.AsyncAggConfig(**ASYNC_CFG)) if engine == "async" else {}
        return jfed.make_runner("fibecfed", world["model"], world["loss_fn"], FL, world["client_data"],
                                optimizer="adamw", engine=engine, seed=7, store=store, **kw)

    return build


def _plain(build, rounds=ROUNDS):
    runner = build()
    runner.init_phase()
    return runner, [runner.run_round(t) for t in range(rounds)]


@pytest.fixture(scope="module")
def baselines(world, tmp_path_factory):
    """Uninterrupted plain port runs (no service, no checkpoints), cached
    per (engine, store kind): what every resumed run must match."""
    cache = {}

    def get(engine, store_kind):
        if (engine, store_kind) not in cache:
            workdir = str(tmp_path_factory.mktemp(f"base-{engine}-{store_kind}"))
            cache[engine, store_kind] = _plain(_factory(world, engine, store_kind, workdir))
        return cache[engine, store_kind]

    return get


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _trees_close(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, atol=5e-5, rtol=1e-4)


def _assert_resume_equals_uninterrupted(engine, base, resumed):
    base_runner, base_hist = base
    runner, fed = resumed
    assert len(fed.history) == ROUNDS
    if engine == "async":
        _trees_close(base_runner.global_lora, runner.global_lora)
        for hb, hr in zip(base_hist, fed.history):
            assert hr["loss"] == pytest.approx(hb["loss"], rel=1e-5, abs=1e-7)
            # staleness, clock and drop accounting identical, not close
            for k in ASYNC_STATS:
                assert hr[k] == hb[k], f"round accounting diverged on {k!r}"
    else:
        _trees_equal(base_runner.global_lora, runner.global_lora)
        for hb, hr in zip(base_hist, fed.history):
            assert hr["loss"] == hb["loss"]
            assert hr["selected_batches"] == hb["selected_batches"]
    # comm bytes charged once per round: a resume that replayed a recorded
    # round (or restored a mid-round partial) would charge it twice
    assert runner.comm_bytes_per_round == base_runner.comm_bytes_per_round
    assert runner.comm_upload_bytes_per_round == base_runner.comm_upload_bytes_per_round


# -- the kill/resume matrix ---------------------------------------------------

# _dispatch_round is called once per round: at=2 dies in round 1, after round
# 0's checkpoint exists. "post_round" dies after the round's work but before
# the service recorded or checkpointed it; "mid_checkpoint" kills the second
# snapshot's manifest commit, leaving a partial directory to sweep.
_COMMON = [
    FaultPoint("pre_round", "runner:_dispatch_round", at=2, before=True),
    FaultPoint("post_round", "runner:_dispatch_round", at=2, before=False),
    FaultPoint("mid_checkpoint", "ckpt:manifest", at=2, before=True),
]
# between dispatch and merge: clients trained and buffered, nothing merged
_ASYNC = [FaultPoint("dispatch_merge_gap", "scheduler:_flush", at=2, before=True)]
# during_spill: an eviction or flush write that never finished; mid_flush:
# the checkpoint's store flush completed but serialization never followed
_OOC = [
    FaultPoint("during_spill", "store:_spill", at=12, before=True),
    FaultPoint("mid_flush", "store:flush", at=2, before=False),
]


def _matrix():
    cases = []
    for engine in ("loop", "vectorized", "async"):
        for store_kind in ("mem", "ooc"):
            points = list(_COMMON) if store_kind == "mem" else [_COMMON[0]] + _OOC
            if engine == "async":
                points += _ASYNC
            cases += [pytest.param(engine, store_kind, p, id=f"{engine}-{store_kind}-{p.name}") for p in points]
    return cases


@pytest.mark.parametrize("engine,store_kind,fault", _matrix())
def test_kill_resume_matrix(world, baselines, tmp_path, engine, store_kind, fault):
    base = baselines(engine, store_kind)
    resumed = kill_and_resume(_factory(world, engine, store_kind, str(tmp_path)), rounds=ROUNDS,
                              ckpt_dir=str(tmp_path / "ckpt"), fault=fault, ckpt_every=1)
    _assert_resume_equals_uninterrupted(engine, base, resumed)


# -- checkpointing must never perturb a run -----------------------------------


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A 1-rank gloo process group on a FileStore: the sharded engine's
    runner builds its CPU client mesh over it."""
    dist = torch.distributed
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "group_store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["loop", "vectorized", "sharded", "async"])
def test_service_without_checkpointing_is_noop(world, baselines, engine, tmp_path):
    """ckpt_every=0: no checkpoint I/O, and the run is exactly the
    hand-driven runner (the sharded engine on one gloo rank)."""
    with one_rank_group(tmp_path) if engine == "sharded" else contextlib.nullcontext():
        base_runner, base_hist = baselines(engine, "mem")
        runner = _factory(world, engine, "mem", "")()
        svc = FederationService()
        fed = svc.launch("noop", runner, rounds=ROUNDS)
        svc.run()
    assert runner.engine == engine
    assert fed.state == "completed" and fed.ckpt_dir is None
    _trees_equal(base_runner.global_lora, runner.global_lora)
    assert [h["loss"] for h in base_hist] == [h["loss"] for h in fed.history]
    assert runner.comm_bytes_per_round == base_runner.comm_bytes_per_round


@pytest.mark.parametrize("engine,store_kind", [("vectorized", "ooc"), ("async", "mem")])
def test_uninterrupted_run_with_checkpointing_matches_plain(world, baselines, tmp_path, engine, store_kind):
    """Taking checkpoints every round (without ever crashing) does not
    change a number: snapshotting is observation, not interference."""
    base_runner, base_hist = baselines(engine, store_kind)
    runner = _factory(world, engine, store_kind, str(tmp_path))()
    svc = FederationService()
    fed = svc.launch("steady", runner, rounds=ROUNDS, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1)
    svc.run()
    assert fed.state == "completed"
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"round_{t:08d}" for t in range(2, ROUNDS + 1)]  # keep=3
    _trees_equal(base_runner.global_lora, runner.global_lora)
    assert [h["loss"] for h in base_hist] == [h["loss"] for h in fed.history]
    assert runner.comm_bytes_per_round == base_runner.comm_bytes_per_round


# -- multi-tenant service -----------------------------------------------------


def test_two_federations_share_one_service(world, baselines, tmp_path):
    """Two federations (different engines) interleave round-robin in one
    process and each reproduces its solo run; pause, resume and status."""
    base_vec, base_async = baselines("vectorized", "mem"), baselines("async", "mem")
    svc = FederationService()
    r_vec = _factory(world, "vectorized", "mem", "")()
    r_async = _factory(world, "async", "mem", "")()
    f_vec = svc.launch("vec", r_vec, rounds=ROUNDS)
    f_async = svc.launch("async", r_async, rounds=ROUNDS, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    svc.tick()
    svc.pause("vec")
    svc.tick()
    assert f_vec.next_round == 1 and f_async.next_round == 2
    assert svc.status("vec")["state"] == "paused"
    svc.resume("vec")
    svc.run()
    assert f_vec.state == "completed" and f_async.state == "completed"
    _trees_equal(base_vec[0].global_lora, r_vec.global_lora)
    _trees_close(base_async[0].global_lora, r_async.global_lora)
    assert [h["loss"] for h in base_vec[1]] == [h["loss"] for h in f_vec.history]
    assert r_async.comm_bytes_per_round == base_async[0].comm_bytes_per_round
    assert set(svc.status()) == {"vec", "async"}
    with pytest.raises(ValueError, match="already exists"):
        svc.launch("vec", r_vec)


# -- across frameworks ----------------------------------------------------------

SPLIT = 2  # the snapshot holds the state after rounds 0 and 1


@pytest.fixture(scope="module")
def jax_runs(world, tmp_path_factory):
    """JAX's uninterrupted run per (engine, store kind), with the snapshot it
    took after round SPLIT - 1 (snapshotting does not perturb a JAX run)."""
    cache = {}

    def get(engine, store_kind):
        if (engine, store_kind) not in cache:
            workdir = tmp_path_factory.mktemp(f"jax-{engine}-{store_kind}")
            build = _jax_factory(world, engine, store_kind, str(workdir))
            r = build()
            r.init_phase()
            hist = [r.run_round(t) for t in range(SPLIT)]
            snap = j_fedckpt.save_run_checkpoint(str(workdir / "ckpt"), r, SPLIT)
            hist += [r.run_round(t) for t in range(SPLIT, ROUNDS)]
            cache[engine, store_kind] = dict(runner=r, hist=hist, snap=snap, build=build, workdir=workdir)
        return cache[engine, store_kind]

    return get


def _np_leaves(tree):
    """A LoRA tree's leaves as f32 numpy, whichever framework holds it."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        return tree_leaves(to_numpy(tree))
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _continues_like(engine, runner, hist, ref):
    """Rounds SPLIT.. of ``runner`` (either framework) against JAX's
    uninterrupted run at the slice tolerances, accounting identical."""
    for hr, h in zip(ref["hist"][SPLIT:], hist):
        assert h["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        assert h["selected_batches"] == hr["selected_batches"]
        if engine == "async":
            assert {k: h[k] for k in ASYNC_STATS} == {k: hr[k] for k in ASYNC_STATS}
    got, want = _np_leaves(runner.global_lora), _np_leaves(ref["runner"].global_lora)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4)
    assert list(runner.comm_bytes_per_round) == list(ref["runner"].comm_bytes_per_round)
    assert list(runner.comm_upload_bytes_per_round) == list(ref["runner"].comm_upload_bytes_per_round)


def _layout(path):
    """A snapshot's arrays as {key: (shape, dtype name)}, its host state's
    key paths, and its cold files."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        manifest = json.loads(bytes(data["__repro_dtype_manifest__"]).decode("utf-8"))
        arrays = {k: (data[k].shape, manifest[k]) for k in data.files if k != "__repro_dtype_manifest__"}
    with open(os.path.join(path, "MANIFEST.json")) as f:
        host = json.load(f)

    def paths(x, prefix=""):
        if isinstance(x, dict):
            return {p for k, v in x.items() for p in paths(v, f"{prefix}/{k}")} | {prefix}
        if isinstance(x, list):
            return {p for i, v in enumerate(x) for p in paths(v, f"{prefix}[{i}]")} | {prefix}
        return {prefix}

    return arrays, paths(host), sorted(host["store_files"])


CROSS = [("loop", "mem"), ("vectorized", "mem"), ("async", "mem"), ("vectorized", "ooc")]


@pytest.mark.parametrize("engine,store_kind", CROSS, ids=[f"{e}-{s}" for e, s in CROSS])
def test_jax_snapshot_restores_into_the_port(world, jax_runs, tmp_path, engine, store_kind):
    ref = jax_runs(engine, store_kind)
    port = _factory(world, engine, store_kind, str(tmp_path), ref=ref["runner"])()
    extra = fedckpt.restore_runner(port, ref["snap"])
    assert extra == {}
    hist = [port.run_round(t) for t in range(SPLIT, ROUNDS)]
    _continues_like(engine, port, hist, ref)


@pytest.mark.parametrize("engine,store_kind", CROSS, ids=[f"{e}-{s}" for e, s in CROSS])
def test_port_snapshot_restores_into_jax(world, jax_runs, tmp_path, engine, store_kind):
    ref = jax_runs(engine, store_kind)
    port = _factory(world, engine, store_kind, str(tmp_path), ref=ref["runner"])()
    port.init_phase()
    for t in range(SPLIT):
        port.run_round(t)
    snap = fedckpt.save_run_checkpoint(str(tmp_path / "ckpt"), port, SPLIT)
    # the same run's two snapshots: the same keys, shapes, dtype names and
    # host state layout
    assert _layout(snap) == _layout(ref["snap"])
    fresh = ref["build"]()
    j_fedckpt.restore_runner(fresh, snap)
    hist = [fresh.run_round(t) for t in range(SPLIT, ROUNDS)]
    _continues_like(engine, fresh, hist, ref)
