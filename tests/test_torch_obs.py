"""The port's observability copy (``repro_torch.obs``) and the runner's
``telemetry=``.

The cases of ``tests/test_obs.py`` that need no JAX run on both packages'
modules: the copy must behave as the original. Then the bit-identity contract of
the JAX package on the port's runner: enabling telemetry changes no bit of
any stat, comm count or global LoRA, on ``loop`` and ``vectorized``, and
the init phase's spans nest under ``init_phase``.
"""
import json
import math

import pytest

pytest.importorskip("torch").set_num_threads(1)  # xdist workers share the cores: no thread pool each

import numpy as np
import torch

import repro.obs as j_obs
import repro.obs.metrics as j_metrics
import repro_torch.obs as t_obs
import repro_torch.obs.metrics as t_metrics
from repro_torch.config import FibecFedConfig, ModelConfig
from repro_torch.data import dirichlet_partition, make_keyword_task
from repro_torch.federated import make_runner
from repro_torch.models import build_model
from repro_torch.train import make_loss_fn
from repro_torch.utils.tree import tree_leaves

PACKAGES = pytest.mark.parametrize("obs,metrics", [(j_obs, j_metrics), (t_obs, t_metrics)], ids=["jax", "port"])


@PACKAGES
def test_counter_gauge_basics(obs, metrics):
    reg = obs.MetricsRegistry()
    c = reg.counter("x")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    assert reg.counter("x") is c
    g = reg.gauge("y")
    g.set(4)
    g.set(1.5)
    assert g.value == 1.5


@PACKAGES
def test_histogram_math(obs, metrics):
    h = obs.MetricsRegistry().histogram("h")
    for v in (0.5, 1.0, 3.0, 4.0, -1.0):
        h.observe(v)
    assert h.count == 5
    assert h.total == pytest.approx(7.5)
    assert h.mean == pytest.approx(1.5)
    assert h.vmin == -1.0 and h.vmax == 4.0
    assert h.buckets == {"-1": 1, "0": 1, "2": 2, "-inf": 1}
    snap = h.snapshot()
    assert snap["count"] == 5 and snap["buckets"]["2"] == 2
    assert json.loads(json.dumps(snap)) == snap


@PACKAGES
def test_bucket_edges_powers_of_two(obs, metrics):
    b = metrics._bucket_exponent
    assert b(2.0) == "1"
    assert b(2.0 + 1e-9) == "2"
    assert b(1.0) == "0"
    assert b(0.0) == "-inf"
    assert b(-5.0) == "-inf"
    for e in range(-8, 9):
        v = math.ldexp(1.0, e)
        assert b(v) == str(e)
        assert b(v * 1.001) == str(e + 1)


@PACKAGES
def test_metric_name_bound_to_one_kind(obs, metrics):
    reg = obs.MetricsRegistry()
    reg.counter("n")
    with pytest.raises(ValueError):
        reg.gauge("n")
    with pytest.raises(ValueError):
        reg.histogram("n")


@PACKAGES
def test_registry_snapshot_and_reset(obs, metrics):
    reg = obs.MetricsRegistry()
    reg.counter("c").inc(2)
    reg.gauge("g").set(7)
    reg.histogram("h").observe(1)
    snap = reg.snapshot()
    assert snap["counters"] == {"c": 2.0}
    assert snap["gauges"] == {"g": 7.0}
    assert snap["histograms"]["h"]["count"] == 1
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


@PACKAGES
def test_null_registry_is_inert(obs, metrics):
    reg = obs.NullRegistry()
    assert reg.counter("a") is metrics.NULL_METRIC
    reg.counter("a").inc(5)
    reg.gauge("b").set(1)
    reg.histogram("c").observe(2)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


@PACKAGES
def test_tracer_span_contextmanager_records_args(obs, metrics):
    tr = obs.Tracer()
    with tr.span("work", cat="t", track="host", args={"a": 1}) as sargs:
        sargs["b"] = 2
    (ev,) = tr.events
    assert ev["type"] == "span" and ev["name"] == "work"
    assert ev["clock"] == obs.WALL and ev["args"] == {"a": 1, "b": 2}
    assert ev["ts"] >= 0.0 and ev["dur"] >= 0.0


@PACKAGES
def test_tracer_add_span_virtual_and_clamping(obs, metrics):
    tr = obs.Tracer()
    tr.add_span("up", start=3.0, end=5.0, clock=obs.VIRTUAL, track="client/0")
    tr.add_span("zero", start=5.0, end=4.0, clock=obs.VIRTUAL, track="client/0")
    assert tr.events[0]["ts"] == 3.0 and tr.events[0]["dur"] == 2.0
    assert tr.events[1]["dur"] == 0.0
    with pytest.raises(ValueError):
        tr.add_span("bad", start=0, end=1, clock="lamport")
    with pytest.raises(ValueError):
        tr.instant("bad", clock="lamport")


@PACKAGES
def test_check_spans_accepts_nesting_and_disjoint(obs, metrics):
    tr = obs.Tracer()
    tr.add_span("outer", start=0.0, end=10.0, clock=obs.VIRTUAL, track="a")
    tr.add_span("inner", start=2.0, end=5.0, clock=obs.VIRTUAL, track="a")
    tr.add_span("later", start=10.0, end=12.0, clock=obs.VIRTUAL, track="a")
    tr.add_span("other", start=1.0, end=11.0, clock=obs.VIRTUAL, track="b")
    obs.check_spans(tr.events)


@PACKAGES
def test_check_spans_rejects_partial_overlap(obs, metrics):
    tr = obs.Tracer()
    tr.add_span("a", start=0.0, end=5.0, clock=obs.VIRTUAL, track="a")
    tr.add_span("b", start=3.0, end=8.0, clock=obs.VIRTUAL, track="a")
    with pytest.raises(ValueError, match="partially overlaps"):
        obs.check_spans(tr.events)
    tr2 = obs.Tracer()
    tr2.add_span("a", start=0.0, end=5.0, clock=obs.VIRTUAL, track="a")
    tr2.add_span("b", start=3.0, end=8.0, clock=obs.WALL, track="a")
    obs.check_spans(tr2.events)


def _sample_telemetry(obs):
    tel = obs.Telemetry(run_id="t", meta={"k": "v"})
    with tel.span("host_work", cat="test"):
        pass
    tel.tracer.add_span("virt", start=1.0, end=2.0, clock=obs.VIRTUAL, track="client/1",
                        args={"upload_bytes": 10})
    tel.instant("mark", cat="test")
    tel.metrics.counter("c").inc(3)
    tel.metrics.histogram("h").observe(2.0)
    return tel


@PACKAGES
def test_jsonl_round_trip_validates(obs, metrics, tmp_path):
    tel = _sample_telemetry(obs)
    path = str(tmp_path / "trace.jsonl")
    n = tel.export_jsonl(path)
    counts = obs.validate_jsonl(path)
    assert counts == {"manifest": 1, "span": 2, "instant": 1, "metrics": 1}
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == n
    assert lines[0]["type"] == "manifest" and lines[0]["run_id"] == "t"
    assert lines[-1]["snapshot"]["counters"]["c"] == 3.0
    assert "runtime" in lines[-1]["snapshot"]


@PACKAGES
def test_jsonl_validation_rejects_malformed(obs, metrics, tmp_path):
    with pytest.raises(obs.SchemaError):
        obs.validate_event({"type": "span", "name": "x"})
    with pytest.raises(obs.SchemaError):
        obs.validate_event({"type": "span", "name": "x", "cat": "c", "track": "t", "clock": "lamport",
                            "ts": 0, "dur": 0, "args": {}})
    with pytest.raises(obs.SchemaError):
        obs.validate_event({"type": "instant", "name": "x", "cat": "c", "track": "t", "clock": obs.WALL,
                            "ts": -1.0, "args": {}})
    p = tmp_path / "bad.jsonl"
    p.write_text('{"type": "metrics", "snapshot": {}}\n')
    with pytest.raises(obs.SchemaError, match="manifest"):
        obs.validate_jsonl(str(p))


@PACKAGES
def test_perfetto_export_loads_and_separates_clocks(obs, metrics, tmp_path):
    tel = _sample_telemetry(obs)
    path = str(tmp_path / "trace.json")
    tel.export_perfetto(path)
    evs = json.load(open(path))["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    assert {e["pid"] for e in xs} == {1, 2}
    virt = next(e for e in xs if e["pid"] == 2)
    assert virt["ts"] == pytest.approx(1e6) and virt["dur"] == pytest.approx(1e6)
    assert virt["args"]["upload_bytes"] == 10
    assert any(e.get("ph") == "i" for e in evs)
    names = {e["args"]["name"] for e in evs if e.get("ph") == "M" and e["name"] == "process_name"}
    assert len(names) == 2


@PACKAGES
def test_ensure_normalizes_none(obs, metrics):
    assert obs.ensure(None) is obs.NULL_TELEMETRY
    tel = obs.Telemetry()
    assert obs.ensure(tel) is tel
    assert isinstance(obs.NULL_TELEMETRY, obs.NullTelemetry)
    assert not obs.NULL_TELEMETRY.enabled


@PACKAGES
def test_null_telemetry_is_inert(obs, metrics):
    with obs.NULL_TELEMETRY.span("x", cat="y", args={"a": 1}) as sargs:
        sargs["b"] = 2
    obs.NULL_TELEMETRY.instant("x")
    assert obs.NULL_TELEMETRY.tracer.events == []
    assert obs.NULL_TELEMETRY.snapshot() == {}
    with pytest.raises(RuntimeError):
        obs.NULL_TELEMETRY.export_jsonl("/dev/null")
    with pytest.raises(RuntimeError):
        obs.NULL_TELEMETRY.export_perfetto("/dev/null")


def test_port_runtime_registry_stays_empty():
    """The port compiles no programs: nothing counts into runtime_metrics,
    and a snapshot still carries its (empty) ``runtime`` key."""
    assert t_obs.runtime_metrics is not j_obs.runtime_metrics
    assert t_obs.Telemetry().snapshot()["runtime"] == {"counters": {}, "gauges": {}, "histograms": {}}


# ---------------------------------------------------------------------------
# the runner's telemetry= (the JAX package's tests/test_obs.py world)
# ---------------------------------------------------------------------------

CFG = ModelConfig(
    name="obs-lm", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
    vocab_size=256, head_dim=16, rope="full", norm="rmsnorm", mlp="swiglu", dtype="float32", lora_rank=2,
    max_seq_len=64,
)
FL = FibecFedConfig(
    num_devices=4, devices_per_round=2, rounds=4, batch_size=4, learning_rate=5e-3, fim_warmup_epochs=1,
    gal_fraction=0.5, sparse_ratio=0.5,
)
ROUNDS = 2


@pytest.fixture(scope="module")
def world():
    model = build_model(CFG)
    task = make_keyword_task(n_samples=50, seq_len=12, vocab_size=256, seed=0)
    parts = dirichlet_partition(task.data["label"], FL.num_devices, 1.0, seed=0)
    client_data = [{k: v[idx] for k, v in task.data.items() if k != "label"} for idx in parts]
    return model, make_loss_fn(model), client_data


def _run_fl(world, engine, telemetry=None, rounds=ROUNDS):
    model, loss_fn, client_data = world
    runner = make_runner("fibecfed", model, loss_fn, FL, client_data, optimizer="adamw", engine=engine,
                         seed=7, telemetry=telemetry, device="cpu")
    runner.init_phase()
    return runner, [runner.run_round(t) for t in range(rounds)]


@pytest.mark.parametrize("engine", ["loop", "vectorized", "sharded"])
def test_enabled_telemetry_is_bit_identical(world, engine, tmp_path):
    """Enabling telemetry changes no bit of a run, on each engine (the
    sharded one on a 1-rank gloo group, as the JAX test runs it on a
    1-device mesh)."""
    dist = torch.distributed
    sharded = engine == "sharded"
    if sharded:
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "group_store"), 1), rank=0,
                                world_size=1)
    try:
        r_off, h_off = _run_fl(world, engine)
        tel = t_obs.Telemetry(run_id=f"bitid/{engine}")
        r_on, h_on = _run_fl(world, engine, telemetry=tel)
    finally:
        if sharded:
            dist.destroy_process_group()
    assert r_on.engine == engine
    for ho, hn in zip(h_off, h_on):
        assert ho == hn  # every stat float, bitwise
    assert r_off.comm_bytes_per_round == r_on.comm_bytes_per_round
    assert r_off.comm_upload_bytes_per_round == r_on.comm_upload_bytes_per_round
    for a, b in zip(tree_leaves(r_off.global_lora), tree_leaves(r_on.global_lora)):
        assert torch.equal(a, b)
    events = tel.tracer.events
    t_obs.check_spans(events)
    assert sum(1 for e in events if e["name"] == "round") == ROUNDS
    assert sum(1 for e in events if e["name"] == "init_phase") == 1
    snap = tel.snapshot()
    assert snap["counters"]["fl.rounds"] == ROUNDS
    assert snap["counters"]["fl.comm_bytes"] == sum(r_on.comm_bytes_per_round)
    assert snap["counters"]["fl.comm_upload_bytes"] == sum(r_on.comm_upload_bytes_per_round)
    assert snap["histograms"]["fl.round_loss"]["count"] == ROUNDS
    assert not any(k.startswith("jit.") for kind in ("counters", "gauges") for k in snap[kind])


def test_init_phase_spans_nest_under_init(world):
    tel = t_obs.Telemetry()
    _run_fl(world, "vectorized", telemetry=tel, rounds=1)
    spans = {e["name"]: e for e in tel.tracer.events if e["type"] == "span"}
    for name in ("difficulty", "sensitivity", "fim_warmup"):
        inner, outer = spans[name], spans["init_phase"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-9
    rd = spans["round"]
    assert np.isfinite(rd["args"]["loss"]) and rd["args"]["t"] == 0 and rd["args"]["engine"] == "vectorized"
    assert rd["ts"] >= spans["init_phase"]["ts"] + spans["init_phase"]["dur"]
