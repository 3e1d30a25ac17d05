"""The port's async engine against the JAX package's.

Three layers, each held to its JAX twin:

- the numpy pieces (``federated/hetero.py``, ``federated/async_agg.py``'s
  helpers and ``AsyncAggConfig``, ``core/curriculum.py::step_plan``'s caps)
  exactly: equal arrays, equal errors;
- the event scheduler, driven by stub callbacks (no model) over every
  scenario preset and knob: every ``MergeResult`` field, the cohort and
  scenario RNG states after each merge, and the virtual-clock telemetry;
- the runner on the tiny-lm world of ``tests/test_engine_equivalence.py``
  (50 samples over 4 clients with ragged final batches, seed 7), starting
  from the JAX runner's params and initial LoRA.

The runner compares use the slice tolerances (losses rel 1e-4 / abs 1e-5,
LoRA atol 5e-5 / rtol 1e-4). fedavg_lora/sgd's round-2 global LoRA is held
at atol 5e-4 (ROADMAP.md C2: that configuration amplifies f32 rounding; a
1e-7 change of the weights moves JAX's own round-2 LoRA by 7e-5). Compressed
AdamW runs take the tie allowance of ``tests/test_torch_engine_compress.py``
(C3: top-k on Adam's first steps sits amid exact ties). Decisions (cohorts,
virtual clock, staleness, drops, buffer sizes, comm bytes) depend on no
float the model computes, so they are compared exactly.

The JAX runs are cached for the module: each configuration runs once.
"""
import dataclasses
import json

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import numpy as np
import torch

from repro.config import FibecFedConfig, ModelConfig
from repro.core import curriculum as j_curr
from repro.data import dirichlet_partition, make_keyword_task
import repro.federated as jfed
from repro.federated import AsyncAggConfig, HierarchyConfig, make_runner
from repro.federated import async_agg as j_agg
from repro.federated import hetero as j_het
from repro.federated import hierarchy as j_hier
from repro.models import build_model
from repro.obs import Telemetry
from repro.train import make_loss_fn

import repro_torch.config as tconfig
import repro_torch.federated as tfed
from repro_torch.convert import to_numpy
from repro_torch.core import curriculum as t_curr
from repro_torch.federated import async_agg as t_agg
from repro_torch.federated import hetero as t_het
from repro_torch.federated import hierarchy as t_hier
from repro_torch.models import build_model as t_build_model
from repro_torch.obs import Telemetry as TTelemetry
from repro_torch.train import make_loss_fn as t_make_loss_fn
from repro_torch.utils.tree import flatten_dict, tree_clone, tree_leaves, unflatten_dict
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
ROUNDS = 2
R = CFG.lora_rank
TOPK = dict(mode="topk", topk_ratio=0.25, topk_values="int8")
# the JAX package's straggler run with every adaptive policy
# (tests/test_engine_equivalence.py::test_async_adaptive_policies_straggler_run),
# with 3 clients in flight over the buffer of 2: at the default concurrency
# (the cohort, 2) every wave of this 4-client world lands at once, and no
# update is ever stale. The scheduler cases below add dispatch-time
# staleness prediction and observed pacing.
STRAGGLER_POLICIES = dict(buffer_size=2, concurrency=3, merge_mode="delta", server_lr=0.8, staleness_cutoff=2,
                          adapt_buffer=True, adapt_steps=True, sampling_bias=2.0)
HOST_STATS = ("selected_batches", "comm_bytes", "virtual_time", "staleness_mean", "merged_clients",
              "dropped_clients", "stale_dropped", "buffer_size", "padded_steps")


# ---------------------------------------------------------------------------
# the numpy pieces
# ---------------------------------------------------------------------------


def _raises_alike(j_fn, t_fn):
    """Both raise, with the same exception type and message."""
    with pytest.raises(Exception) as je:
        j_fn()
    with pytest.raises(Exception) as te:
        t_fn()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def test_pure_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(25):
        k = int(rng.integers(1, 7))
        n = rng.integers(1, 60, size=k)
        tau = rng.integers(0, 6, size=k)
        power = float(rng.choice([0.0, 0.5, 1.3]))
        lr = float(rng.uniform(0.1, 2.0))
        assert np.array_equal(t_agg.staleness_weights(n, tau, power), j_agg.staleness_weights(n, tau, power))
        assert np.array_equal(t_agg.delta_weights(n, tau, power, lr), j_agg.delta_weights(n, tau, power, lr))
        speed = rng.choice([1.0, 2.0, 4.0], size=k)
        bias, prog = float(rng.uniform(0, 3)), float(rng.uniform(-0.2, 1.2))
        assert np.array_equal(t_agg.cohort_weights(speed, bias, prog), j_agg.cohort_weights(speed, bias, prog))
        base, rate = int(rng.integers(1, 9)), float(rng.uniform(0, 1))
        lo = int(rng.integers(1, base + 1))
        assert t_agg.adapted_buffer_size(base, rate, lo) == j_agg.adapted_buffer_size(base, rate, lo)
        steps, rel, mn = int(rng.integers(1, 20)), float(rng.uniform(0.5, 5)), int(rng.integers(1, 4))
        assert t_agg.adapted_step_count(steps, rel, mn) == j_agg.adapted_step_count(steps, rel, mn)
    for spec in (0.7, ("constant", 0.5, 0.0), ("inv_sqrt", 1.0, 0.5), ("exp", 2.0, 0.1), lambda t: 1.0 / (1 + t)):
        for t in range(6):
            assert t_agg.resolve_server_lr(spec, t) == j_agg.resolve_server_lr(spec, t)
    for j_fn, t_fn, args in [
        (j_agg.staleness_weights, t_agg.staleness_weights, ([1, 2], [0, -1], 0.5)),
        (j_agg.staleness_weights, t_agg.staleness_weights, ([0, 0], [0, 0], 0.5)),
        (j_agg.delta_weights, t_agg.delta_weights, ([0], [0], 0.5)),
        (j_agg.adapted_buffer_size, t_agg.adapted_buffer_size, (4, 1.5)),
        (j_agg.adapted_buffer_size, t_agg.adapted_buffer_size, (4, 0.5, 5, 4)),
        (j_agg.adapted_step_count, t_agg.adapted_step_count, (0, 2.0)),
        (j_agg.cohort_weights, t_agg.cohort_weights, (np.ones(3), -1.0, 0.0)),
        (j_agg.cohort_weights, t_agg.cohort_weights, (np.zeros(3), 1.0, 0.0)),
        (j_agg.resolve_server_lr, t_agg.resolve_server_lr, (("cosine", 1.0, 0.0), 0)),
    ]:
        _raises_alike(lambda: j_fn(*args), lambda: t_fn(*args))
    g_j, g_t = j_agg.DoubleBufferedGlobal("v0"), t_agg.DoubleBufferedGlobal("v0")
    for g in (g_j, g_t):
        g.publish("v1")
    assert (g_t.front, g_t.back, g_t.version) == (g_j.front, g_j.back, g_j.version)


@pytest.mark.parametrize("kw", [
    dict(buffer_size=0), dict(concurrency=0), dict(staleness_power=-0.1), dict(merge_mode="fedprox"),
    dict(server_lr=0.0), dict(server_lr=("inv_sqrt", 1.0)), dict(server_lr=("cosine", 1.0, 0.0)),
    dict(server_lr=("exp", -1.0, 0.0)), dict(server_lr=("exp", 1.0, -0.5)), dict(staleness_cutoff=-1),
    dict(predict_staleness=True), dict(min_buffer_size=0), dict(min_buffer_size=3, max_buffer_size=2),
    dict(min_steps=0), dict(pace_mode="wall"), dict(sampling_bias=-1.0), dict(compression="int8"),
])
def test_async_cfg_errors_match_jax(kw):
    _raises_alike(lambda: AsyncAggConfig(**kw), lambda: t_agg.AsyncAggConfig(**kw))


def test_async_cfg_fields_match_jax():
    assert [f.name for f in dataclasses.fields(t_agg.AsyncAggConfig)] == \
        [f.name for f in dataclasses.fields(AsyncAggConfig)]
    assert dataclasses.asdict(t_agg.AsyncAggConfig()) == dataclasses.asdict(AsyncAggConfig())


def _presets():
    j_extra = {
        "composed": j_het.STRAGGLER.compose(j_het.BURSTY),
        "tweaked": j_het.MOBILE.with_(slow_factor=8.0, burst_period=3.0),
    }
    t_extra = {
        "composed": t_het.STRAGGLER.compose(t_het.BURSTY),
        "tweaked": t_het.MOBILE.with_(slow_factor=8.0, burst_period=3.0),
    }
    return [(name, j_het.SCENARIOS[name], t_het.SCENARIOS[name]) for name in j_het.SCENARIOS] + \
        [(name, j_extra[name], t_extra[name]) for name in j_extra]


@pytest.mark.parametrize("name,j_preset,t_preset", _presets(), ids=[p[0] for p in _presets()])
def test_scenarios_bind_like_jax(name, j_preset, t_preset):
    """Every preset (and a composed and a tweaked one), bound at several
    sizes and seeds: the same speeds, rank budgets, bandwidths, times,
    drops and dispatch times, drawing the same scenario stream."""
    assert dataclasses.asdict(t_preset) == dataclasses.asdict(j_preset)
    assert sorted(t_het.SCENARIOS) == sorted(j_het.SCENARIOS)
    for C in (1, 4, 8, 33):
        for seed in (0, 7, 7 + j_het.SCENARIO_SEED_OFFSET):
            jb, tb = j_preset.bind(C, seed=seed), t_preset.bind(C, seed=seed)
            for field in ("speed", "rank_fraction", "bandwidth"):
                assert np.array_equal(getattr(tb, field), getattr(jb, field)), field
            for rank in (1, 2, 8, 64):
                assert np.array_equal(tb.client_ranks(rank), jb.client_ranks(rank))
            steps = np.random.default_rng(seed).integers(1, 9, size=3 * C)
            for i, n in enumerate(steps):
                ci = i % C
                assert tb.rel_speed(ci) == jb.rel_speed(ci)
                assert tb.comm_leg_time(ci) == jb.comm_leg_time(ci)
                assert tb.round_trip_time(ci, int(n)) == jb.round_trip_time(ci, int(n))
                assert tb.compute_time(ci, int(n)) == jb.compute_time(ci, int(n))
                assert tb.is_dropped(ci) == jb.is_dropped(ci)
                clock = float(n) * 1.37
                assert tb.dispatch_time(clock) == jb.dispatch_time(clock)
            chosen = list(range(min(C, 4)))
            assert t_het.sync_round_time(tb, chosen, [3] * len(chosen)) == \
                j_het.sync_round_time(jb, chosen, [3] * len(chosen))
            assert tb.rng.bit_generator.state == jb.rng.bit_generator.state


def test_scenario_lookup_and_validation_match_jax():
    assert t_het.SCENARIO_SEED_OFFSET == j_het.SCENARIO_SEED_OFFSET
    assert t_het.get_scenario(None) == t_het.UNIFORM
    assert t_het.get_scenario("mobile") is t_het.SCENARIOS["mobile"]
    custom = t_het.ScenarioPreset(name="custom", slow_fraction=0.5)
    assert t_het.get_scenario(custom) is custom
    _raises_alike(lambda: j_het.get_scenario("nope"), lambda: t_het.get_scenario("nope"))
    for kw in (dict(slow_factor=0.5), dict(slow_fraction=1.5), dict(dropout_prob=1.0),
               dict(slow_rank_fraction=0.0), dict(bandwidth_factor=0.9)):
        _raises_alike(lambda: j_het.ScenarioPreset(**kw), lambda: t_het.ScenarioPreset(**kw))


def test_step_plan_caps_match_jax():
    """The async engine's step caps: ``max_selected`` as in JAX, and
    uncapped (``None`` or every entry ``None``) the synchronous plan."""
    rng = np.random.default_rng(3)
    for strategy in ("linear", "none"):
        js = j_curr.CurriculumSchedule(strategy=strategy, beta=0.3, alpha=0.8, total_rounds=6)
        ts = t_curr.CurriculumSchedule(strategy=strategy, beta=0.3, alpha=0.8, total_rounds=6)
        for t in range(7):
            orders = [rng.permutation(int(n)) for n in rng.integers(1, 13, size=3)]
            caps = [None, 1, int(rng.integers(0, 5))]
            for epochs in (1, 2):
                for kw in (dict(), dict(max_selected=caps), dict(max_selected=[None] * len(orders))):
                    jb, jv = j_curr.step_plan(js, t, orders, epochs, **kw)
                    tb, tv = t_curr.step_plan(ts, t, orders, epochs, **kw)
                    assert np.array_equal(tb, jb) and np.array_equal(tv, jv)
                    assert tb.dtype == jb.dtype and tv.dtype == jv.dtype


def test_hierarchy_helpers_match_jax():
    for C, E in ((4, 1), (4, 3), (7, 2), (3, 5)):
        assert np.array_equal(t_hier.edge_assignments(C, E), j_hier.edge_assignments(C, E))
    assert t_hier.get_hierarchy(None) == t_hier.HierarchyConfig()
    assert t_hier.get_hierarchy(3) == t_hier.HierarchyConfig(num_edges=3)
    assert t_hier.HierarchyConfig(3, [0, 2, 1]).assignments == HierarchyConfig(3, [0, 2, 1]).assignments
    for make in (lambda m: m.HierarchyConfig(num_edges=0), lambda m: m.HierarchyConfig(2, [0, 2]),
                 lambda m: m.HierarchyConfig(2, [[0, 1]]), lambda m: m.get_hierarchy("two"),
                 lambda m: m.edge_assignments(0, 1)):
        _raises_alike(lambda: make(j_hier), lambda: make(t_hier))
    x = [{"a": torch.full((2, 3), float(i))} for i in range(3)]
    for assignments, error in (([0, 1], "must map all"), ([0, 5, 1, 0], "must lie in")):
        with pytest.raises(ValueError, match=error):
            t_hier.edge_reduce(t_hier.build_edge_summary_fn(), x, np.ones(3) / 3, [0, 1, 2], 4, 2, assignments)
    with pytest.raises(ValueError, match="align"):
        t_hier.edge_reduce(t_hier.build_edge_summary_fn(), x, np.ones(2), [0, 1, 2], 4, 2)


# ---------------------------------------------------------------------------
# the scheduler, event for event (stub callbacks, no model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StubUpdate:
    client: int
    n_samples: int
    n_steps: int
    pulled_version: int
    round_t: int
    comm_bytes: int
    upload_bytes: int


def _stub_callbacks(trained):
    """``tests/test_async_agg.py``'s stub callbacks, with step counts that
    differ between clients (observed pacing sees them) and byte fields
    (stale-dropped bytes are charged)."""

    def plan(ci, t):
        return 1 + (ci + t) % 3

    def train(ci, t, version):
        u = StubUpdate(client=ci, n_samples=10 + ci, n_steps=plan(ci, t), pulled_version=version, round_t=t,
                       comm_bytes=1000 + 7 * ci, upload_bytes=400 + 3 * ci)
        trained.append((ci, t, version))
        return u

    return plan, train


SCHED_CASES = {
    "uniform": ("uniform", dict()),
    "uniform_cutoff_inert": ("uniform", dict(staleness_cutoff=0, adapt_buffer=True)),
    "straggler_k1": ("straggler", dict(buffer_size=1)),
    "straggler_k2_cutoff": ("straggler", dict(buffer_size=2, staleness_cutoff=1)),
    "straggler_bias": ("straggler", dict(buffer_size=2, sampling_bias=2.0)),
    "straggler_predict": ("straggler", dict(buffer_size=1, staleness_cutoff=1, predict_staleness=True)),
    "dropout_adapt": ("dropout", dict(buffer_size=3, adapt_buffer=True, min_buffer_size=1)),
    "bursty_delta": ("bursty", dict(buffer_size=2, merge_mode="delta", server_lr=("inv_sqrt", 1.0, 0.5))),
    "mobile_all": ("mobile", dict(buffer_size=3, concurrency=6, merge_mode="delta", server_lr=0.8,
                                  staleness_cutoff=2, adapt_buffer=True, sampling_bias=1.0,
                                  predict_staleness=True)),
    "constrained_observed": ("constrained", dict(buffer_size=2, pace_mode="observed", adapt_steps=True,
                                                 staleness_power=1.0)),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_matches_jax_event_for_event(case):
    preset, kw = SCHED_CASES[case]
    C, k, seed = 8, 4, 11
    scheds, trained = [], []
    for agg, het, tel_cls in ((j_agg, j_het, Telemetry), (t_agg, t_het, TTelemetry)):
        log = []
        trained.append(log)
        sched = agg.AsyncScheduler(
            num_clients=C, cohort_size=k, scenario=het.get_scenario(preset).bind(C, seed=seed + 1),
            rng=np.random.default_rng(seed), cfg=agg.AsyncAggConfig(**kw),
            progress=lambda t: min(1.0, t / 6.0), telemetry=tel_cls(run_id=case),
        )
        scheds.append((sched, _stub_callbacks(log)))
    (js, (jp, jt)), (ts, (tp, tt)) = scheds
    for t in range(10):
        jr, tr = js.run_until_merge(t, jp, jt), ts.run_until_merge(t, tp, tt)
        assert [dataclasses.astuple(u) for u in tr.updates] == [dataclasses.astuple(u) for u in jr.updates]
        assert np.array_equal(tr.weights, jr.weights) and tr.weights.dtype == jr.weights.dtype
        assert np.array_equal(tr.staleness, jr.staleness)
        for field in ("clock", "version", "completed", "dropped", "stale_dropped", "stale_dropped_bytes",
                      "stale_dropped_upload_bytes"):
            assert getattr(tr, field) == getattr(jr, field), field
        assert ts.rng.bit_generator.state == js.rng.bit_generator.state
        assert ts.scenario.rng.bit_generator.state == js.scenario.rng.bit_generator.state
        assert (ts.buffer_size, ts.in_flight, ts.total_completed, ts.total_dropped, ts.total_stale_dropped) == \
            (js.buffer_size, js.in_flight, js.total_completed, js.total_dropped, js.total_stale_dropped)
        assert [ts.observed_rel_speed(c) for c in range(C)] == [js.observed_rel_speed(c) for c in range(C)]
        assert [ts.predicted_staleness(c, 3) for c in range(C)] == [js.predicted_staleness(c, 3) for c in range(C)]
    assert trained[1] == trained[0]
    assert ts.tel.tracer.events == js.tel.tracer.events
    t_snap, j_snap = ts.tel.snapshot(), js.tel.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert t_snap[kind] == j_snap[kind], kind


def _payload_callbacks(agg, as_tensor):
    """Stub callbacks whose payloads are real ``ClientUpdate``s with small
    LoRA, delta and loss arrays (numpy for JAX, tensors for the port)."""
    plan, _ = _stub_callbacks([])

    def train(ci, t, version):
        n = plan(ci, t)
        rng = np.random.default_rng(100 * ci + t)
        lora = {"layers": {"q": {"a": rng.standard_normal((2, 3)).astype(np.float32)}}}
        losses = rng.standard_normal(4).astype(np.float32)
        if as_tensor:
            lora = {"layers": {"q": {"a": torch.from_numpy(lora["layers"]["q"]["a"])}}}
            losses = torch.from_numpy(losses)
        return agg.ClientUpdate(client=ci, lora=lora, delta=lora if ci % 2 else None, losses=losses,
                                step_valid=(np.arange(4) < n).astype(np.float32), n_samples=10 + ci, n_steps=n,
                                n_selected=n, pulled_version=version, round_t=t, comm_bytes=1000 + 7 * ci,
                                upload_bytes=400 + 3 * ci)

    return plan, train


def _merge_fields(r):
    return ([(u.client, u.n_steps, u.pulled_version, u.round_t) for u in r.updates], r.weights.tolist(),
            r.staleness.tolist(), r.clock, r.version, r.completed, r.dropped, r.stale_dropped,
            r.stale_dropped_bytes)


def test_scheduler_errors_and_checkpoints():
    """The constructor's errors as JAX's. The snapshot after 3 merges (with
    events and their payloads on the heap) equals JAX's host state exactly
    and its payload arrays bit for bit; restored into a fresh scheduler, the
    port's snapshot and JAX's both continue merge for merge as the
    uninterrupted run."""
    for kw in (dict(buffer_size=9), dict(concurrency=9), dict(min_buffer_size=3, buffer_size=2)):
        def make(agg, het):
            return agg.AsyncScheduler(num_clients=8, cohort_size=4, scenario=het.UNIFORM.bind(8),
                                      rng=np.random.default_rng(0), cfg=agg.AsyncAggConfig(**kw))
        _raises_alike(lambda: make(j_agg, j_het), lambda: make(t_agg, t_het))
    preset, kw = SCHED_CASES["mobile_all"]

    def make(agg, het):
        return agg.AsyncScheduler(num_clients=8, cohort_size=4, scenario=het.get_scenario(preset).bind(8, seed=12),
                                  rng=np.random.default_rng(11), cfg=agg.AsyncAggConfig(**kw),
                                  progress=lambda t: min(1.0, t / 6.0))

    js, ts = make(j_agg, j_het), make(t_agg, t_het)
    jcb, tcb = _payload_callbacks(j_agg, False), _payload_callbacks(t_agg, True)
    for t in range(3):
        js.run_until_merge(t, *jcb)
        ts.run_until_merge(t, *tcb)
    (jh, ja), (th, ta) = js.checkpoint_state(), ts.checkpoint_state()
    assert th == jh and any(e["payload"] for e in th["heap"])
    assert json.loads(json.dumps(th)) == th
    t_flat, j_flat = flatten_dict(ta), flatten_dict(ja)
    assert t_flat.keys() == j_flat.keys()
    for k, v in t_flat.items():
        got = v.numpy() if isinstance(v, torch.Tensor) else v
        assert got.dtype == j_flat[k].dtype and np.array_equal(got, j_flat[k]), k
    resumed = []
    for host, arrays in ((th, ta), (jh, unflatten_dict({k: torch.from_numpy(np.array(v)) for k, v in j_flat.items()}))):
        r = make(t_agg, t_het)
        r.rng.bit_generator.state = ts.rng.bit_generator.state  # the runner's snapshot carries the cohort RNG
        r.restore_checkpoint_state(host, arrays)
        assert r.checkpoint_state()[0] == th
        resumed.append(r)
    for t in range(3, 6):
        want = _merge_fields(ts.run_until_merge(t, *tcb))
        for r in resumed:
            got = r.run_until_merge(t, *_payload_callbacks(t_agg, True))
            assert _merge_fields(got) == want
            assert r.rng.bit_generator.state == ts.rng.bit_generator.state


# ---------------------------------------------------------------------------
# the runner on the tiny-lm world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    t_cfg = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    t_model = t_build_model(t_cfg)
    return dict(model=model, loss_fn=make_loss_fn(model), t_model=t_model, t_loss_fn=t_make_loss_fn(t_model),
                client_data=client_data, jax_runs={})


def _kw(kw, fed):
    """Runner arguments for a configuration written with plain dicts, in
    the types of ``fed`` (``repro.federated`` or ``repro_torch.federated``)."""
    out = dict(kw)
    if "async_cfg" in out:
        cfg = dict(out["async_cfg"])
        if "compression" in cfg:
            cfg["compression"] = fed.CompressionConfig(**cfg["compression"])
        out["async_cfg"] = fed.AsyncAggConfig(**cfg)
    if "compression" in out:
        out["compression"] = fed.CompressionConfig(**out["compression"])
    if isinstance(out.get("hierarchy"), dict):
        out["hierarchy"] = fed.HierarchyConfig(**out["hierarchy"])
    return out


def _key(baseline, optimizer, engine, rounds, kw):
    return repr((baseline, optimizer, engine, rounds, sorted(kw.items())))


def _jax_run(world, baseline="fibecfed", optimizer="adamw", engine="async", rounds=ROUNDS, telemetry=False, **kw):
    """The JAX runner after init and ``rounds`` rounds, and its stats (once
    per configuration in this module)."""
    key = _key(baseline, optimizer, engine, rounds, dict(kw, telemetry=telemetry))
    if key not in world["jax_runs"]:
        tel = Telemetry(run_id="jax") if telemetry else None
        r = make_runner(baseline, world["model"], world["loss_fn"], FL, world["client_data"], optimizer=optimizer,
                        engine=engine, seed=7, telemetry=tel, **_kw(kw, jfed))
        r.init_phase()
        world["jax_runs"][key] = (r, [r.run_round(t) for t in range(rounds)], tel)
    return world["jax_runs"][key]


def _port(world, ref, baseline="fibecfed", optimizer="adamw", engine="async", **kw):
    return tfed.make_runner(
        baseline, world["t_model"], world["t_loss_fn"], tconfig.FibecFedConfig(**dataclasses.asdict(FL)),
        world["client_data"], optimizer=optimizer, engine=engine, seed=7, device="cpu",
        init_params=jax.tree.map(np.asarray, ref.params), init_lora=jax.tree.map(np.asarray, ref._init_lora),
        **_kw(kw, tfed),
    )


def _port_run(world, ref, rounds=ROUNDS, **kw):
    port = _port(world, ref, **kw)
    port.init_phase()
    return port, [port.run_round(t) for t in range(rounds)]


def _assert_decisions(ref, port, h_ref, h_port):
    for cr, cp in zip(ref.clients, port.clients):
        np.testing.assert_array_equal(cr.order, cp.order)
    np.testing.assert_array_equal(ref.gal_layers, port.gal_layers)
    for hr, hp in zip(h_ref, h_port):
        assert set(hp) == set(hr)
        assert hp["loss"] == pytest.approx(hr["loss"], rel=1e-4, abs=1e-5)
        assert {k: hp[k] for k in HOST_STATS} == {k: hr[k] for k in HOST_STATS}
    assert port.comm_bytes_per_round == ref.comm_bytes_per_round
    assert port.comm_upload_bytes_per_round == ref.comm_upload_bytes_per_round
    assert all(isinstance(b, int) for b in port.comm_bytes_per_round + port.comm_upload_bytes_per_round)
    assert port._global.version == ref._global.version == len(h_ref)


def _assert_close(port_tree, ref_tree, atol=5e-5, allowance=None):
    got = tree_leaves(to_numpy(port_tree))
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(ref_tree)]
    assert len(got) == len(want)
    if allowance is None:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)
        return
    frac, max_diff = allowance
    diffs = [np.abs(g - w) for g, w in zip(got, want)]
    bad = np.concatenate([(d > 5e-5 + 1e-4 * np.abs(w)).ravel() for d, w in zip(diffs, want)])
    assert bad.mean() <= frac, bad.mean()
    assert max(d.max() for d in diffs) < max_diff


DEGENERATE = [("fibecfed", "adamw", False), ("fedavg_lora", "sgd", False), ("fibecfed", "adamw", True)]


@pytest.mark.parametrize("baseline,optimizer,fused", DEGENERATE)
def test_degenerate_async_matches_jax_async(world, baseline, optimizer, fused):
    """JAX's ``test_async_equivalent_to_loop`` configurations: the uniform
    scenario with the cohort as buffer, against JAX's async run."""
    ref, h_ref, _ = _jax_run(world, baseline, optimizer, fused_optimizer=fused)
    port, h_port = _port_run(world, ref, baseline=baseline, optimizer=optimizer, fused_optimizer=fused)
    _assert_decisions(ref, port, h_ref, h_port)
    for h in h_port:
        assert h["staleness_mean"] == 0.0 and h["dropped_clients"] == 0.0 and h["stale_dropped"] == 0.0
    atol = 5e-4 if baseline == "fedavg_lora" else 5e-5  # C2, see the module docstring
    _assert_close(port.global_lora, ref.global_lora, atol=atol)
    for cr, cp in zip(ref.clients, port.clients):
        _assert_close(cp.lora, cr.lora, atol=atol)
    assert port._global.back is not None


@pytest.mark.parametrize("baseline,optimizer,fused", DEGENERATE)
def test_degenerate_async_is_the_port_loop(world, baseline, optimizer, fused):
    """The degenerate async round is the loop round: the same cohort, the
    same local steps (bit for bit: one B1/B2 step per valid step, on the
    same batches in the same order), the same comm bytes and stats. Only
    the merge differs (a tensordot, not the host loop)."""
    ref, _, _ = _jax_run(world, baseline, optimizer, fused_optimizer=fused)
    runs = {}
    for engine in ("loop", "async"):
        r = _port(world, ref, baseline=baseline, optimizer=optimizer, engine=engine, fused_optimizer=fused)
        r.init_phase()
        runs[engine] = (r, r.run_round(0))
    (rl, hl), (ra, ha) = runs["loop"], runs["async"]
    np.testing.assert_array_equal(rl.last_round_info["chosen"], ra.last_round_info["chosen"])
    np.testing.assert_array_equal(rl.last_round_info["client_steps"], ra.last_round_info["client_steps"])
    for cl, ca in zip(rl.clients, ra.clients):
        for a, b in zip(tree_leaves(cl.lora) + tree_leaves(cl.opt_state), tree_leaves(ca.lora) + tree_leaves(ca.opt_state)):
            assert torch.equal(a, b)
    assert rl.comm_bytes_per_round == ra.comm_bytes_per_round
    assert ha["selected_batches"] == hl["selected_batches"] and ha["comm_bytes"] == hl["comm_bytes"]
    assert ha["loss"] == pytest.approx(hl["loss"], rel=1e-12)  # one f64 mean against another
    for a, b in zip(tree_leaves(rl.global_lora), tree_leaves(ra.global_lora)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("async_cfg", [
    dict(merge_mode="delta", server_lr=1.0),
    dict(adapt_steps=True, adapt_buffer=True, staleness_cutoff=0),
], ids=["delta_lr1", "inert_policies"])
def test_delta_merge_and_inert_policies_match_jax(world, async_cfg):
    """The delta merge at server_lr 1, and the adaptive policies left inert
    by the homogeneous world, against JAX's same configuration."""
    ref, h_ref, _ = _jax_run(world, async_cfg=async_cfg)
    port, h_port = _port_run(world, ref, async_cfg=async_cfg)
    _assert_decisions(ref, port, h_ref, h_port)
    _assert_close(port.global_lora, ref.global_lora)


def test_straggler_run_with_every_policy_matches_jax(world):
    """8 merges under the straggler scenario with every adaptive policy:
    every host field of every stats dict equal to JAX's; the slowest
    client's plan capped to ceil(n/4) of its selected batches."""
    kw = dict(scenario="straggler", async_cfg=STRAGGLER_POLICIES)
    ref, h_ref, _ = _jax_run(world, rounds=8, **kw)
    port, h_port = _port_run(world, ref, rounds=8, **kw)
    _assert_decisions(ref, port, h_ref, h_port)
    _assert_close(port.global_lora, ref.global_lora)
    assert max(h["staleness_mean"] for h in h_port) > 0.0
    assert all(h["staleness_mean"] <= 2.0 and 1.0 <= h["buffer_size"] <= 2.0 for h in h_port)
    sched = port._scheduler
    plan, _ = port._async_callbacks(FL.learning_rate, sched)
    slow, fast = int(np.argmax(sched.scenario.speed)), int(np.argmin(sched.scenario.speed))
    assert sched.scenario.rel_speed(slow) == 4.0
    full = len(t_curr.selected_batch_ids(port.schedule, 0, port.clients[slow].order))
    assert plan(slow, 0) == max(1, int(np.ceil(full / 4.0)))
    assert plan(fast, 0) == len(t_curr.selected_batch_ids(port.schedule, 0, port.clients[fast].order))
    assert sched.rng.bit_generator.state == ref._scheduler.rng.bit_generator.state


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("merge_mode", ["buffered", "delta"])
def test_compressed_with_derived_ranks_matches_jax(world, optimizer, merge_mode):
    """``scenario="constrained"`` derives the slow clients' ranks; top-k int8
    uploads with error feedback through ``async_cfg.compression``, taken
    against each client's pulled version. AdamW at C3's tie allowance."""
    kw = dict(scenario="constrained", async_cfg=dict(buffer_size=2, merge_mode=merge_mode, compression=TOPK))
    ref, h_ref, _ = _jax_run(world, optimizer=optimizer, rounds=4, **kw)
    port, h_port = _port_run(world, ref, optimizer=optimizer, rounds=4, **kw)
    assert np.array_equal(port.client_ranks, ref.client_ranks)
    assert np.any(port.client_ranks < R) and np.any(port.client_ranks == R)
    _assert_decisions(ref, port, h_ref, h_port)
    allowance = (0.02, 2e-2) if optimizer == "adamw" else None
    _assert_close(port.global_lora, ref.global_lora, allowance=allowance)
    for cr, cp in zip(ref.clients, port.clients):
        _assert_close(cp.ef_residual, cr.ef_residual, allowance=allowance)
    for total, up in zip(port.comm_bytes_per_round, port.comm_upload_bytes_per_round):
        assert up < total - up  # the compressed push is cheaper than the raw pull


def test_hierarchy_one_edge_is_the_flat_merge_bit_for_bit(world):
    ref, _, _ = _jax_run(world)
    flat, h_flat = _port_run(world, ref)
    edge, h_edge = _port_run(world, ref, hierarchy=1)
    assert h_edge == h_flat
    for a, b in zip(tree_leaves(flat.global_lora), tree_leaves(edge.global_lora)):
        assert torch.equal(a, b)
    assert edge.comm_bytes_per_round == flat.comm_bytes_per_round


@pytest.mark.parametrize("hierarchy", [2, 3, dict(num_edges=3, assignments=(0, 0, 1, 2)),
                                       dict(num_edges=4, assignments=(2, 0, 0, 3))],
                         ids=["E2", "E3", "E3-lopsided", "E4-empty-edge"])
def test_hierarchy_edges_match_jax(world, hierarchy):
    """Edges reassociate the weighted sum; against JAX's same topology, with
    a straggler buffer of 3 so that flushes span edges."""
    kw = dict(hierarchy=hierarchy, scenario="straggler", async_cfg=dict(buffer_size=3))
    ref, h_ref, _ = _jax_run(world, rounds=3, **kw)
    port, h_port = _port_run(world, ref, rounds=3, **kw)
    _assert_decisions(ref, port, h_ref, h_port)
    _assert_close(port.global_lora, ref.global_lora)


@pytest.mark.parametrize("kw", [
    dict(engine="vectorized", scenario="straggler"),
    dict(engine="loop", async_cfg=dict(buffer_size=1)),
    dict(engine="loop", hierarchy=2),
    dict(engine="async", compression=dict(mode="int8"), async_cfg=dict(compression=TOPK)),
    dict(engine="async", scenario="nope"),
    dict(engine="async", hierarchy=0),
], ids=["scenario_on_sync", "async_cfg_on_sync", "hierarchy_on_sync", "compression_conflict",
        "unknown_scenario", "no_edges"])
def test_constructor_errors_match_jax(world, kw):
    kw = dict(kw)
    engine = kw.pop("engine")

    def jax_make():
        make_runner("fibecfed", world["model"], world["loss_fn"], FL, world["client_data"], engine=engine, seed=7,
                    **_kw(kw, jfed))

    def port_make():
        tfed.make_runner("fibecfed", world["t_model"], world["t_loss_fn"],
                         tconfig.FibecFedConfig(**dataclasses.asdict(FL)), world["client_data"], engine=engine,
                         seed=7, device="cpu", **_kw(kw, tfed))

    _raises_alike(jax_make, port_make)


def test_pulled_versions_survive_later_merges(world):
    """Stragglers train against the version they pulled, and payloads hold
    references to it: no merge, delta or compression may write a published
    global in place. Every version pulled, and every payload, still holds
    its bits after all later merges."""
    ref, _, _ = _jax_run(world)
    port = _port(world, ref, scenario="straggler",
                 async_cfg=dict(buffer_size=1, merge_mode="delta", compression=dict(mode="int8")))
    port.init_phase()
    pulled, made = [], []
    callbacks = port._async_callbacks

    def recording(lr, sched):
        plan, train = callbacks(lr, sched)

        def train_rec(ci, t, version):
            pulled.append((version, port._global.front, tree_clone(port._global.front)))
            u = train(ci, t, version)
            made.append((u, tree_clone(u.lora), tree_clone(u.delta)))
            return u

        return plan, train_rec

    port._async_callbacks = recording
    stats = [port.run_round(t) for t in range(6)]
    assert max(h["staleness_mean"] for h in stats) > 0.0
    assert {v for v, _, _ in pulled} >= {0, 1, 2}
    for _, live, snap in pulled:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(live), tree_leaves(snap)))
    for u, lora, delta in made:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(u.lora), tree_leaves(lora)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(u.delta), tree_leaves(delta)))


def _virtual(events):
    return [e for e in events if e["clock"] == "virtual"]


def test_telemetry_matches_jax_and_changes_no_bit(world):
    """A straggler run with ``telemetry=``: its virtual-clock spans and
    instants and its ``async.*`` metrics equal JAX's, the upload spans add
    up to the charged upload bytes; and telemetry off gives the same run
    bit for bit."""
    kw = dict(scenario="straggler", async_cfg=dict(buffer_size=2))
    ref, h_ref, j_tel = _jax_run(world, rounds=6, telemetry=True, **kw)
    tel = TTelemetry(run_id="port")
    port, h_port = _port_run(world, ref, rounds=6, telemetry=tel, **kw)
    off, h_off = _port_run(world, ref, rounds=6, **kw)
    _assert_decisions(ref, port, h_ref, h_port)
    events, j_events = _virtual(tel.tracer.events), _virtual(j_tel.tracer.events)
    assert events == j_events and len(events) > 6
    snap, j_snap = tel.snapshot(), j_tel.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        mine = {k: v for k, v in snap[kind].items() if k.startswith("async.")}
        assert mine == {k: v for k, v in j_snap[kind].items() if k.startswith("async.")}, kind
    assert snap["counters"]["async.merges"] == 6
    assert not any(k.startswith("jit.") for kind in ("counters", "gauges") for k in snap[kind])
    ups = sum(e["args"]["upload_bytes"] for e in events if e["name"] == "upload")
    assert ups == sum(port.comm_upload_bytes_per_round) == snap["counters"]["fl.comm_upload_bytes"]
    assert h_off == h_port
    assert off.comm_bytes_per_round == port.comm_bytes_per_round
    for a, b in zip(tree_leaves(off.global_lora), tree_leaves(port.global_lora)):
        assert torch.equal(a, b)
