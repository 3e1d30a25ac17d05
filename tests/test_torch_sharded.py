"""The port's sharded engine (``engine="sharded"``) against the loop and
vectorized engines, on gloo ranks on the CPU.

The world of ``tests/test_engine_equivalence.py``'s sharded tests: tiny-lm,
53 samples over 5 clients, cohort 3 (``FL5``), FibecFed/AdamW, seed 11, 2
rounds. A multi-rank case spawns G ranks (``tests/torch_sharded_rank.py``,
which imports the port only) on a gloo ``FileStore`` under ``tmp_path``, one
spawn a world size running every configuration for it; each rank writes
what it saw to ``.npz`` files, and each child is joined with a timeout of
its own, so a hung collective fails its test rather than stalling the suite.
One-rank cases run in this process on a 1-rank gloo group made and
destroyed by the test. The JAX side is built here and hands the port its
initial params and LoRA.

- At G = 1, 2 and 4 (``C_stack`` 5, 6 and 8: padding rows at 2 and 4) the
  sharded run holds to the JAX loop engine and the port's: losses within
  rel 1e-4 / abs 1e-5, identical comm-byte integers and batch counts, the
  same curriculum orders and GAL layers, the global and every client's
  LoRA within atol 5e-5 / rtol 1e-4; every rank reports the same run, holds
  ``C_stack / G`` rows and refuses to read a client it does not own.
- At one rank it is the vectorized engine bit for bit (SGD fused and not,
  and the compressed round: top-k int8 with error feedback and per-client
  ranks); at two ranks the compressed AdamW round holds to the port loop's
  within ``tests/test_torch_engine_compress.py``'s top-k tie allowance.
- ``pad_clients_to=`` gives the JAX package's arrays; the refusals are the
  JAX runner's; a 2-rank snapshot resumed by two fresh ranks repeats the
  uninterrupted round bit for bit, and a snapshot of JAX's sharded runner
  on a 1-device mesh continues on a 1-rank port runner at the slice
  tolerances.
"""
import contextlib
import dataclasses
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np
import torch.distributed as dist

import torch_sharded_rank as ranks
from repro.checkpoint import federation as j_fedckpt
from repro.config import FibecFedConfig, ModelConfig
from repro.data import dirichlet_partition, make_keyword_task
from repro.data.pipeline import stack_clients as j_stack_clients
from repro.data.pipeline import stack_cohort as j_stack_cohort
from repro.federated import make_runner
from repro.launch.mesh import make_client_mesh as j_make_client_mesh
from repro.models import build_model
from repro.train import make_loss_fn

import repro_torch.config as tconfig
from repro_torch.checkpoint import restore_runner
from repro_torch.convert import to_numpy
from repro_torch.data.pipeline import stack_clients, stack_cohort
from repro_torch.federated import CompressionConfig as TCompressionConfig
from repro_torch.federated import OutOfCoreStore
from repro_torch.federated import make_runner as t_make_runner
from repro_torch.launch.mesh import dp_axes, make_client_mesh, num_client_groups
from repro_torch.models import build_model as t_build_model
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import tree_leaves
from torch_jax_refs import release_jax_programs  # noqa: F401

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, rope="full",
    norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2, max_seq_len=64,
)
FL5 = FibecFedConfig(
    num_devices=5, devices_per_round=3, rounds=4, batch_size=4,
    learning_rate=5e-3, fim_warmup_epochs=1, gal_fraction=0.5, sparse_ratio=0.5,
)
ROUNDS = 2
SEED = 11
R = CFG.lora_rank
COMP = dict(mode="topk", topk_ratio=0.25, topk_values="int8")  # error feedback on
COMP_RANKS = [R, 1, 1, R, R]
EQUIV = dict(name="equiv", optimizer="adamw", seed=SEED, rounds=ROUNDS)
COMPRESSED = {opt: dict(name=f"compressed_{opt}", optimizer=opt, fused=True, seed=SEED, rounds=ROUNDS,
                        compression=COMP, client_ranks=COMP_RANKS) for opt in ("sgd", "adamw")}
JOIN_S = 300  # each child's own join timeout


# -- worlds and reference runs ------------------------------------------------


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=53, seq_len=12, vocab_size=256, seed=3)
    parts = dirichlet_partition(task.data["label"], FL5.num_devices, 1.0, seed=3)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    loss_fn = make_loss_fn(model)
    # the JAX loop run (C5: the port holds to JAX's loop engine); its
    # params and initial LoRA start every port run
    ref = make_runner("fibecfed", model, loss_fn, FL5, client_data, optimizer="adamw", engine="loop", seed=SEED)
    ref.init_phase()
    ref_hist = [ref.run_round(t) for t in range(ROUNDS)]
    return dict(model=model, loss_fn=loss_fn, t_model=t_model, t_loss_fn=t_make_loss_fn(t_model),
                client_data=client_data, ref=ref, ref_hist=ref_hist,
                init_params=jax.tree.map(np.asarray, ref.params),
                init_lora=jax.tree.map(np.asarray, ref._init_lora))


def _port(world, engine, *, optimizer="adamw", fused=False, seed=SEED, compression=None, client_ranks=None, **kw):
    return t_make_runner(
        "fibecfed", world["t_model"], world["t_loss_fn"], tconfig.FibecFedConfig(**dataclasses.asdict(FL5)),
        world["client_data"], optimizer=optimizer, fused_optimizer=fused, engine=engine, seed=seed,
        device="cpu", compression=None if compression is None else TCompressionConfig(**compression),
        client_ranks=client_ranks, init_params=world["init_params"], init_lora=world["init_lora"], **kw)


def _drive(runner, rounds=ROUNDS):
    runner.init_phase()
    return [runner.run_round(t) for t in range(rounds)]


@pytest.fixture(scope="module")
def port_runs(world):
    """The port loop engine's runs: the equivalence run and the compressed ones."""
    out = {}
    for engine, run in (("loop", EQUIV), ("loop", COMPRESSED["sgd"]), ("loop", COMPRESSED["adamw"])):
        kw = {k: run[k] for k in ("optimizer", "seed", "compression", "client_ranks") if k in run}
        r = _port(world, engine, fused=run.get("fused", False), **kw)
        out[engine, run["name"]] = (r, _drive(r))
    return out


@contextlib.contextmanager
def one_rank(tmp_path):
    """A 1-rank gloo group on a FileStore of its own, and its CPU client mesh."""
    fd, path = tempfile.mkstemp(prefix="store", dir=tmp_path)
    os.close(fd)
    os.unlink(path)
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1)
    try:
        yield make_client_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def spawn(G, runs, world, workdir):
    """Run ``runs`` on G spawned ranks; per rank, per run: (meta, arrays)."""
    os.makedirs(workdir, exist_ok=True)
    spec = dict(cfg={f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)},
                fl=dataclasses.asdict(FL5), client_data=world["client_data"], init_params=world["init_params"],
                init_lora=world["init_lora"], runs=runs, out=str(workdir), store=str(workdir / "store"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.main, args=(r, G, spec)) for r in range(G)]
    for p in procs:
        p.start()
    failed = []
    for r, p in enumerate(procs):
        p.join(JOIN_S)
        if p.is_alive():
            p.kill()
            p.join()
            failed.append(f"rank {r} did not finish within {JOIN_S} s (a hung collective?)")
        elif p.exitcode != 0:
            err = workdir / f"rank{r}.err"
            failed.append(f"rank {r} exited {p.exitcode}:\n" + (err.read_text() if err.exists() else ""))
    for p in procs:  # a rank that hung after another failed
        if p.is_alive():
            p.kill()
    assert not failed, "\n".join(failed)
    return {run["name"]: [ranks.load(str(workdir), run["name"], r) for r in range(G)] for run in runs}


@pytest.fixture(scope="module")
def multi(world, tmp_path_factory):
    """One spawn per world size (2: then a second spawn of two fresh ranks
    resuming the equivalence run's snapshot after round 0), cached."""
    cache = {}

    def get(G):
        if G not in cache:
            work = tmp_path_factory.mktemp(f"g{G}")
            if G == 2:
                snap_dir = str(work / "ckpt")
                runs = [dict(EQUIV, snapshot_after=1, snapshot_dir=snap_dir), *COMPRESSED.values()]
                out = spawn(2, runs, world, work / "run")
                resume = dict(EQUIV, name="resumed", resume_from=os.path.join(snap_dir, "round_00000001"),
                              resume_round=1)
                out.update(spawn(2, [resume], world, work / "resume"))
            else:
                out = spawn(G, [EQUIV], world, work / "run")
            cache[G] = out
        return cache[G]

    return get


# -- comparisons ----------------------------------------------------------------


def _leaves(arrays, prefix):
    return [v for k, v in arrays.items() if k.startswith(prefix + "/")]


def _close(got, want, atol=5e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), atol=atol, rtol=1e-4)


def _rows(leaves, ci):
    return [x[ci] for x in leaves]


def _assert_like_loop(hist, comm, orders, gal_layers, global_leaves, client_leaves, loop_runner, loop_hist):
    """A sharded run against a loop run (either framework's) at case 1's limits."""
    for hl, hs in zip(loop_hist, hist):
        assert hs["loss"] == pytest.approx(hl["loss"], rel=1e-4, abs=1e-5)
        assert hs["selected_batches"] == hl["selected_batches"]
    assert list(comm) == list(loop_runner.comm_bytes_per_round)
    for o, c in zip(orders, loop_runner.clients):
        np.testing.assert_array_equal(o, c.order)
    np.testing.assert_array_equal(gal_layers, loop_runner.gal_layers)
    _close(global_leaves, _np(loop_runner.global_lora))
    for ci, c in enumerate(loop_runner.clients):
        _close(client_leaves(ci), _np(c.lora))


def _np(tree):
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        return tree_leaves(to_numpy(tree))
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _one_rank_run(world, tmp_path, run, engine="sharded"):
    kw = {k: run[k] for k in ("optimizer", "fused", "seed", "compression", "client_ranks") if k in run}
    with one_rank(tmp_path) if engine == "sharded" else contextlib.nullcontext() as mesh:
        r = _port(world, engine, **kw, **({"mesh": mesh} if engine == "sharded" else {}))
        hist = _drive(r, run["rounds"])
        pop = {k: tree_leaves(v) for k, v in r.population_state().items()}
    return r, hist, pop


@pytest.mark.parametrize("G", [1, 2, 4])
def test_sharded_equivalent_to_loop(world, port_runs, multi, tmp_path, G):
    """Twin of tests/test_engine_equivalence.py::test_sharded_equivalent_to_loop:
    the port's sharded run against the JAX loop run and the port's."""
    k_pad = -(-FL5.devices_per_round // G) * G
    c_stack = -(-(FL5.num_devices + k_pad - FL5.devices_per_round) // G) * G
    if G == 1:
        r, hist, pop = _one_rank_run(world, tmp_path, EQUIV)
        runs = [(dict(hist=hist, comm=r.comm_bytes_per_round, orders=[c.order for c in r.clients],
                      gal_layers=r.gal_layers, c_stack=r._C_stack, local_rows=r._sample_valid.shape[0],
                      refused=[]),
                 {"global": _np(r.global_lora), "pop_lora": [x.numpy() for x in pop["lora"]]})]
    else:
        runs = [(meta, {"global": _leaves(a, "global"), "pop_lora": _leaves(a, "pop_lora"), "arrays": a})
                for meta, a in multi(G)["equiv"]]
    meta0, arr0 = runs[0]
    assert meta0["c_stack"] == c_stack and c_stack % G == 0 and c_stack >= FL5.num_devices
    loop_runner, loop_hist = port_runs["loop", "equiv"]
    for rank, (meta, arr) in enumerate(runs):
        # every rank reports the same run and holds its block of the stack
        assert meta["local_rows"] == c_stack // G
        assert meta["hist"] == meta0["hist"] and meta["comm"] == meta0["comm"]
        for a, b in zip(arr["global"], arr0["global"]):
            np.testing.assert_array_equal(a, b)
        if G > 1:
            owned = range(rank * c_stack // G, min((rank + 1) * c_stack // G, FL5.num_devices))
            assert meta["owned"] == list(owned)
            assert [ci for ci, _ in meta["refused"]] == [ci for ci in range(FL5.num_devices) if ci not in owned]
            assert all(f"rank {ci // (c_stack // G)}" in msg for ci, msg in meta["refused"])
            for ci in owned:  # a client's view is its owner's stack row
                for v, p in zip(_leaves(arr["arrays"], f"client{ci}"), arr["pop_lora"]):
                    np.testing.assert_array_equal(v, p[ci])
    for loop, hist_ref in ((world["ref"], world["ref_hist"]), (loop_runner, loop_hist)):
        _assert_like_loop(meta0["hist"], meta0["comm"], meta0["orders"], meta0["gal_layers"], arr0["global"],
                          lambda ci: _rows(arr0["pop_lora"], ci), loop, hist_ref)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_matches_vectorized_bitwise_on_one_rank(world, tmp_path, fused):
    """Twin of test_sharded_matches_vectorized_bitwise_on_one_device: one
    rank runs the vectorized engine's operations, so losses, the global
    LoRA, the stacked client state and comm bytes are equal bit for bit."""
    run = dict(optimizer="sgd", fused=fused, seed=2, rounds=ROUNDS)
    rv, hv, pv = _one_rank_run(world, tmp_path, run, engine="vectorized")
    rs, hs, ps = _one_rank_run(world, tmp_path, run)
    assert rs.engine == "sharded" and hv == hs
    assert rv.comm_bytes_per_round == rs.comm_bytes_per_round
    assert rv.comm_upload_bytes_per_round == rs.comm_upload_bytes_per_round
    for a, b in zip(tree_leaves(rv.global_lora), tree_leaves(rs.global_lora)):
        assert torch.equal(a, b)
    assert pv.keys() == ps.keys() and {"lora", "opt", "mask"} <= set(ps)
    for name in pv:
        assert all(torch.equal(a, b) for a, b in zip(pv[name], ps[name])), name


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("G", [1, 2])
def test_sharded_compressed_round(world, port_runs, multi, tmp_path, G, optimizer):
    """Top-k int8 with error feedback and per-client ranks (fused B2/B1,
    B3): bit for bit the vectorized compressed round at one rank. At two
    ranks, against the port loop's run: losses within rel 1e-4 / abs 1e-5,
    identical comm bytes, and the global LoRA and every client's residual
    within ``tests/test_torch_engine_compress.py``'s SGD allowance (at most
    2% of each leaf's entries outside atol 5e-5 / rtol 1e-4, none by more
    than 1e-2). AdamW's deltas sit amid near-ties at the top-k threshold,
    and in this world (5 clients, ranks [2, 1, 1, 2, 2]) any two engines
    tip more of them than C3's 2%: the port's vectorized run is 5.6% of the
    global's entries from its loop run, JAX's own pair 14.6%, and this run
    6.2% (ROADMAP.md, C11; ``scripts/compressed_tie_fractions.py``). So
    AdamW is held at 10% of the tree's entries, each within C3's 2e-2 (a
    flipped entry carries a few Adam steps of 5e-3)."""
    run = COMPRESSED[optimizer]
    if G == 1:
        rv, hv, pv = _one_rank_run(world, tmp_path, run, engine="vectorized")
        rs, hs, ps = _one_rank_run(world, tmp_path, run)
        assert hv == hs and rv.comm_upload_bytes_per_round == rs.comm_upload_bytes_per_round
        for a, b in zip(tree_leaves(rv.global_lora), tree_leaves(rs.global_lora)):
            assert torch.equal(a, b)
        assert pv.keys() == ps.keys() and {"residual", "comp_mask"} <= set(ps)
        for name in pv:
            assert all(torch.equal(a, b) for a, b in zip(pv[name], ps[name])), name
        return
    (m0, a0), (m1, a1) = multi(2)[run["name"]]
    assert m0["hist"] == m1["hist"] and m0["upload"] == m1["upload"]
    loop, loop_hist = port_runs["loop", run["name"]]
    assert m0["comm"] == loop.comm_bytes_per_round and m0["upload"] == loop.comm_upload_bytes_per_round
    for hl, hs in zip(loop_hist, m0["hist"]):
        assert hs["loss"] == pytest.approx(hl["loss"], rel=1e-4, abs=1e-5)
    allowance = (0.02, 1e-2, True) if optimizer == "sgd" else (0.10, 2e-2, False)
    _within_tie_allowance(_leaves(a0, "global"), _np(loop.global_lora), *allowance)
    residuals = _leaves(a0, "pop_residual")
    for ci, c in enumerate(loop.clients):
        _within_tie_allowance(_rows(residuals, ci), _np(c.ef_residual), *allowance)


def _within_tie_allowance(got, want, frac, max_diff, per_leaf):
    diffs = [np.abs(np.asarray(g, np.float32) - w) for g, w in zip(got, want)]
    bads = [d > 5e-5 + 1e-4 * np.abs(w) for d, w in zip(diffs, want)]
    fracs = [b.mean() for b in bads] if per_leaf else [np.concatenate([b.ravel() for b in bads]).mean()]
    assert max(fracs) <= frac, fracs
    assert max(d.max() for d in diffs) < max_diff


@pytest.mark.parametrize("pad_to", [None, 5, 8])
def test_pad_clients_to_matches_jax(world, pad_to):
    """stack_cohort and stack_clients with pad_clients_to= give JAX's arrays
    exactly: inert rows after every real client, client 0's data, zero
    sample_valid, n_batches and n_samples."""
    cd = world["client_data"]
    for got, want in ((stack_clients(cd, 4, pad_clients_to=pad_to), j_stack_clients(cd, 4, pad_clients_to=pad_to)),
                      (stack_cohort(cd[1:4], 4, pad_batches_to=8, pad_clients_to=pad_to),
                       j_stack_cohort(cd[1:4], 4, pad_batches_to=8, pad_clients_to=pad_to))):
        assert got.data.keys() == want.data.keys()
        for k in want.data:
            np.testing.assert_array_equal(got.data[k], want.data[k])
            assert got.data[k].dtype == want.data[k].dtype
        for f in ("sample_valid", "n_batches", "n_samples"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        if pad_to == 8:
            assert got.sample_valid.shape[0] == 8 and not got.sample_valid[len(got.n_samples) - 3:].any()


@pytest.mark.parametrize("case", ["mesh_on_other_engines", "out_of_core", "no_group", "size", "device"])
def test_sharded_refusals(world, tmp_path, case):
    """Twins of test_mesh_rejected_for_unsharded_engines and
    test_out_of_core_rejected_for_sharded, and the mesh's own refusals."""
    if case == "no_group":
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_client_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="init_process_group"):
            _port(world, "sharded")
        return
    with one_rank(tmp_path) as mesh:
        assert dp_axes(mesh) == ("data",) and num_client_groups(mesh) == 1
        if case == "mesh_on_other_engines":
            for engine in ("vectorized", "loop", "async"):
                with pytest.raises(ValueError, match="mesh="):
                    _port(world, engine, mesh=mesh)
        elif case == "out_of_core":
            with pytest.raises(ValueError, match="sharded"):
                _port(world, "sharded", store=OutOfCoreStore(str(tmp_path / "ooc"), hot_slots=2))
        elif case == "size":
            with pytest.raises(ValueError, match="whole process group"):
                make_client_mesh(2, device_type="cpu")
        else:
            meta_mesh = type("Mesh", (), {"device_type": "cuda"})()
            with pytest.raises(ValueError, match="client mesh is on 'cuda'"):
                _port(world, "sharded", mesh=meta_mesh)


def test_two_rank_resume_is_bit_identical(multi):
    """A 2-rank run snapshotted after round 0 (rank 0 writes, both ranks
    gather) and resumed by two fresh ranks: round 1 equals the
    uninterrupted run's bit for bit on both ranks."""
    out = multi(2)
    for (mu, au), (mr, ar) in zip(out["equiv"], out["resumed"]):
        assert mr["hist"] == mu["hist"][1:]
        assert mr["comm"] == mu["comm"] and mr["upload"] == mu["upload"] and mr["chosen"] == mu["chosen"][1:]
        assert mr["orders"] == mu["orders"] and mr["gal_layers"] == mu["gal_layers"]
        for prefix in ("global", "pop_lora"):
            for a, b in zip(_leaves(au, prefix), _leaves(ar, prefix), strict=True):
                np.testing.assert_array_equal(a, b)


def test_jax_sharded_snapshot_restores_into_one_rank(world, tmp_path):
    """A snapshot of JAX's sharded runner on a 1-device mesh, taken after
    round 0, restores into a 1-rank port sharded runner, whose round 1 then
    holds to JAX's round 1 at the slice tolerances."""
    ref = make_runner("fibecfed", world["model"], world["loss_fn"], FL5, world["client_data"], optimizer="adamw",
                      engine="sharded", mesh=j_make_client_mesh(1), seed=SEED)
    ref.init_phase()
    ref.run_round(0)
    snap = j_fedckpt.save_run_checkpoint(str(tmp_path / "jckpt"), ref, 1)
    want = ref.run_round(1)
    with one_rank(tmp_path) as mesh:
        port = _port(world, "sharded", mesh=mesh)
        assert restore_runner(port, snap) == {}
        got = port.run_round(1)
        pop = tree_leaves(port.population_state()["lora"])
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4, abs=1e-5)
    assert got["selected_batches"] == want["selected_batches"]
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    _close(_np(port.global_lora), _np(ref.global_lora))
    _close([x.numpy() for x in pop], _np(ref._stacked_lora))
