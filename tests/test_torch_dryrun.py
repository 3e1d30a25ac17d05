"""The port's dry run (``repro_torch.launch.dryrun``): every step evaluated
on shapes alone over a ``fake`` process group, against the JAX package's
records.

The ``fake`` group is process-wide, so one child process (the port only,
no JAX) runs every record and writes them as JSON; it is joined with a
timeout. The test holds them to:

- reduced qwen2-0.5b and granite-moe-3b-a800m train / prefill / decode
  records on the (2, 2) debug mesh and the (16, 16) production mesh, a
  train record on the (2, 16, 16) two-pod mesh, and reduced mamba2-1.3b,
  zamba2-7b and whisper-large-v3 train / prefill / decode records on all
  three meshes (the SSM scan, the hybrid's and whisper's attentions on each
  rank's heads) are ``ok``, with finite
  roofline terms on H100_SXM, collectives where the mesh has more than one
  rank per axis, and a train step's all-reduce (the GAL aggregation);
- every (arch, shape) pair the JAX model does not support is ``skipped``
  with JAX's reason (the encoder's decode, long-context decode);
- flops grow by the same amount with each layer (2, 3 and 4 layers), the
  counterpart of ``tests/test_hlo_stats.py::test_flops_scale_with_trip_count``:
  4 layers count 1.5-2x the flops of 2;
- ``n_params`` and ``active_fraction`` equal JAX's from ``jax.eval_shape``;
- a ``("pod", "data")`` spec entry becomes ``Shard`` on both mesh dims;
- ``make_production_mesh`` refuses a group of another size, and
  ``make_host_mesh`` shrinks to the group as JAX's does;
- every other dense, MoE, vlm and encoder architecture's reduced records
  on the (2, 2) mesh are ``ok``, but the pairs JAX skips and the encoder's
  prefill (which raises, as JAX's does).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.launch import analysis as j_ana
from repro.models import build_model as j_build_model
from repro.utils import tree_bytes as j_tree_bytes
from torch_jax_refs import release_jax_programs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 420

CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.launch import shardings as shd
spec = json.loads(sys.argv[1])
out = {"records": [], "skips": []}
for arch in ("qwen2-0.5b", "granite-moe-3b-a800m"):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for debug in (True, False):
            out["records"].append(dryrun_one(arch, shape, reduced=True, debug_mesh=debug, verbose=False))
out["records"].append(dryrun_one("qwen2-0.5b", "train_4k", reduced=True, multi_pod=True, verbose=False))
for arch in ("mamba2-1.3b", "zamba2-7b", "whisper-large-v3"):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for mesh in ({"debug_mesh": True}, {}, {"multi_pod": True}):
            out["records"].append(dryrun_one(arch, shape, reduced=True, verbose=False, **mesh))
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh(multi_pod=True, device_type="cpu")
out["placements"] = [repr(p) for p in shd.placements(shd.P(("pod", "data"), None), mesh)]
for arch, shape in spec["skips"]:
    out["skips"].append(dryrun_one(arch, shape, reduced=True, debug_mesh=True, verbose=False))
out["layers"] = {n: dryrun_one("qwen2-0.5b", "train_4k", reduced=True, debug_mesh=True, verbose=False,
                                overrides={"num_layers": n})["hlo_flops"] for n in (2, 3, 4)}
out["families"] = {}
for arch in spec["others"]:
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        try:
            out["families"][f"{arch} {shape}"] = dryrun_one(arch, shape, reduced=True, debug_mesh=True,
                                                           verbose=False)["status"]
        except NotImplementedError as err:
            out["families"][f"{arch} {shape}"] = f"NotImplementedError: {err}"
from repro_torch.launch.dryrun import _fake_group
from repro_torch.launch.mesh import make_host_mesh
_fake_group(4)
try:
    make_production_mesh(device_type="cpu")
except ValueError as err:
    out["production_refused"] = str(err)
out["host_meshes"] = [dict(shd.mesh_shape(make_host_mesh(d, m, device_type="cpu"))) for d, m in ((2, 2), (4, 2))]
with open(spec["out"], "w") as f:
    json.dump(out, f, default=str)
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    skips = [(a, s) for a in sorted(J_ARCHS) for s in J_SHAPES
             if not j_build_model(J_ARCHS[a].reduced()).supports(J_SHAPES[s])]
    path = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    others = sorted(a for a in J_ARCHS if a not in ("qwen2-0.5b", "granite-moe-3b-a800m"))
    spec = json.dumps({"skips": skips, "out": str(path), "others": others})
    proc = subprocess.run([sys.executable, "-c", CHILD, spec], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f), skips


def test_records_are_ok(dry):
    out, _ = dry
    recs = out["records"]
    assert len(recs) == 13 + 27
    for r in recs:
        assert r["status"] == "ok", r
        roof = r["roofline"]
        assert all(roof[k] > 0 and roof[k] < float("inf") for k in ("compute_s", "memory_s", "collective_s")), r
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["memory"]["temp_bytes"] > 0
        assert r["chips"] == (4 if r["mesh"] == {"data": 2, "model": 2} else 512 if r["multi_pod"] else 256)
        assert r["collectives"]["total"] > 0
        if r["shape"] == "train_4k":
            # the GAL gradient's client sum and the loss: all-reduces
            assert r["collective_counts"].get("all-reduce", 0) >= 1
        assert 0 < r["useful_fraction"]
    pod2 = [r for r in recs if r["multi_pod"]]
    assert pod2 and pod2[0]["mesh"] == {"pod": 2, "data": 16, "model": 16}


def test_skipped_pairs_match_jax(dry):
    out, skips = dry
    assert any(a == "roberta-large" and s.startswith("decode") for a, s in skips)
    for (arch, shape), r in zip(skips, out["skips"]):
        assert r["status"] == "skipped", (arch, shape, r)
        want = "encoder-only: no decode" if J_ARCHS[arch].family == "encoder" else \
            "long-context decode requires sub-quadratic attention"
        assert r["reason"] == want


def test_flops_scale_with_layers(dry):
    out, _ = dry
    f = {int(k): v for k, v in out["layers"].items()}
    assert f[4] - f[3] == f[3] - f[2] > 0  # every layer counted, each alike
    assert 1.5 <= f[4] / f[2] <= 2.0


def test_params_and_active_fraction_match_jax(dry):
    out, _ = dry
    for r in out["records"]:
        cfg = J_ARCHS[r["arch"]].reduced()
        n = j_tree_bytes(jax.eval_shape(j_build_model(cfg).init_params, jax.random.PRNGKey(0))) // 2
        assert r["n_params"] == n
        assert r["active_fraction"] == j_ana.active_param_fraction(cfg)


def test_pod_data_entry_shards_both_mesh_dims(dry):
    out, _ = dry
    assert out["placements"] == ["Shard(dim=0)", "Shard(dim=0)", "Replicate()"]


def test_mesh_builders(dry):
    """``make_production_mesh`` refuses a group of another size than its
    (16, 16); ``make_host_mesh`` shrinks its data axis to the group, as
    JAX's does (4 ranks: (2, 2) both times)."""
    out, _ = dry
    assert "256 ranks" in out["production_refused"]
    assert out["host_meshes"] == [{"data": 2, "model": 2}] * 2


def test_every_family_on_the_debug_mesh(dry):
    """Every other architecture's reduced train, prefill and decode records
    on the (2, 2) mesh: ``ok``, but for the pairs JAX skips and the
    encoder's prefill, which raises as JAX's does (no decode path)."""
    out, skips = dry
    assert len(out["families"]) == 27
    for key, status in out["families"].items():
        arch, shape = key.split()
        if (arch, shape) in [tuple(x) for x in skips]:
            assert status == "skipped", key
        elif arch == "roberta-large" and shape == "prefill_32k":
            assert status == "NotImplementedError: encoder-only model has no decode path", key
        else:
            assert status == "ok", (key, status)
