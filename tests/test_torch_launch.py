"""The launch layer of the port against the JAX package's
(``repro.launch.{steps,shardings,analysis}``, ``repro.models.sharding_ctx``).

- ``make_train_state``'s tree equals JAX's (paths, shapes, dtypes) on the
  tiny-lm of ``tests/test_distributed.py``.
- The FibecFed train step (n_groups 2), 1 and 3 steps from the same numpy
  params, state and batch, equals JAX's jitted ``build_train_step`` on the
  tiny-lm and on reduced mamba2-1.3b, zamba2-7b and whisper-large-v3 (its
  batch with seeded frame embeddings): loss within rel 1e-4 / abs 1e-5,
  every state leaf within atol 5e-5 / rtol 1e-4 (the slice tolerances);
  the freeze invariants of ``test_distributed.py`` hold bit for bit (GAL
  LoRA of non-GAL layers, local LoRA of GAL layers, and their moments).
- The prefill and decode steps' logits and caches equal JAX's on the same
  four worlds at ``test_torch_serve.py``'s atol 2e-5 / rtol 1e-4.
- The spec tables (``base_param_spec``, ``lora_spec`` with and without the
  client axis, ``batch_spec``, ``cache_spec``) equal JAX's entry for entry
  on every leaf of every architecture at full size (JAX through
  ``jax.eval_shape``, the port under ``FakeTensorMode``), and so do
  ``_fit(_restrict(...))`` on (16, 16) and (2, 16, 16) stand-in meshes.
- ``model_flops``, ``active_param_fraction`` and ``roofline_terms`` (on
  ``TPU_V5E``) equal JAX's for every architecture.
- With ``seq_parallel=True`` and no mesh the forward is bit-identical.
- The examples ``torch_federated_finetune.py`` and ``torch_serve_batch.py``
  run on the CPU, each under 60 s.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import TPU_V5E as J_TPU_V5E
from repro.config import ModelConfig as JModelConfig
from repro.configs import ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.launch import analysis as j_ana
from repro.launch import shardings as j_shd
from repro.launch.steps import build_decode_step as j_decode_step
from repro.launch.steps import build_prefill_step as j_prefill_step
from repro.launch.steps import build_train_step as j_train_step
from repro.launch.steps import make_train_state as j_make_state
from repro.lora import gal_mask_tree as j_gal_mask_tree
from repro.lora import lora_num_logical_layers as j_num_logical_layers
from repro.models import build_model as j_build_model
from repro.utils import tree_bytes as j_tree_bytes

import repro_torch.config as tconfig
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import INPUT_SHAPES as T_SHAPES
from repro_torch.convert import lora_from_numpy, params_from_numpy
from repro_torch.launch import analysis as t_ana
from repro_torch.launch import shardings as t_shd
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step, make_train_state
from repro_torch.models import build_model as t_build_model
from repro_torch.models import sharding_ctx
from repro_torch.utils.tree import tree_items, tree_map, unflatten_dict
from torch_jax_refs import jax_in_child, release_jax_programs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

CFG = JModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, dtype="float32",
    lora_rank=2, max_seq_len=64,
)
TCFG = tconfig.ModelConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
N_GROUPS = 2
LR = 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
ATOL, RTOL = 5e-5, 1e-4
SERVE_ATOL, SERVE_RTOL = 2e-5, 1e-4


def _flat_np(tree):
    """``{'a/b': numpy}`` of a JAX tree (the port's path convention)."""
    return {k: np.asarray(v) for k, v in tree_items(jax.tree.map(np.asarray, tree))}


def _torch_tree(flat):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), unflatten_dict(flat))


# the step tests' worlds: the tiny-lm and the reduced SSM, hybrid and
# encoder-decoder families (2 layers, d 128; whisper 2 + 2 over 16 frames)
ARCH_CFGS = {"tiny-lm": CFG, "mamba2": J_ARCHS["mamba2-1.3b"].reduced(), "zamba2": J_ARCHS["zamba2-7b"].reduced(),
             "whisper": J_ARCHS["whisper-large-v3"].reduced()}
_WORLDS = {}


def _jax_world(name):
    """A JAX world: params, a train state with b moved off zero (so a has a
    gradient), GAL on the first logical layer only, local masks of ones,
    and a batch (whisper's with seeded N(0, 1) frame embeddings)."""
    if name in _WORLDS:
        return _WORLDS[name]
    cfg = ARCH_CFGS[name]
    model = j_build_model(cfg)
    rng = jax.random.PRNGKey(0)
    params = model.init_params(rng)
    state = j_make_state(model, rng, N_GROUPS)
    r = np.random.default_rng(7)
    state["gal_lora"] = jax.tree.map(lambda x: x + 0.02 * r.standard_normal(x.shape).astype(np.float32),
                                     state["gal_lora"])
    state["local_lora"] = jax.tree.map(lambda x: x + 0.02 * r.standard_normal(x.shape).astype(np.float32),
                                       state["local_lora"])
    gal = np.zeros(j_num_logical_layers(cfg), bool)
    gal[0] = True
    state["gal_mask"] = j_gal_mask_tree(cfg, state["gal_lora"], gal)
    state["local_mask"] = jax.tree.map(jnp.ones_like, state["local_mask"])
    batch = {"tokens": np.asarray(jax.random.randint(rng, (4, 16), 0, cfg.vocab_size), np.int32)}
    if cfg.family == "audio":
        batch["encoder_embeds"] = r.standard_normal((4, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    _WORLDS[name] = (model, params, state, batch)
    return _WORLDS[name]


@pytest.fixture(scope="module")
def world():
    return _jax_world("tiny-lm")


def _tcfg(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}) \
        if cfg is CFG else T_ARCHS[cfg.name].reduced()


def _port_inputs(world):
    model, params, state, batch = world
    t_params = params_from_numpy(jax.tree.map(np.asarray, params), _tcfg(model.cfg), "cpu")
    t_state = _torch_tree(_flat_np(state))
    return t_params, t_state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def check_frozen(final, start):
    """Every entry a mask freezes holds bit for bit (the GAL tree and its
    moments where the GAL mask is 0, the local tree and its moments where
    (1 - GAL mask) x local mask is 0), and each tree moved where it trains."""
    for k, got in final.items():
        kind, _, path = k.partition("/")
        gal = start.get(f"gal_mask/{path}")
        if kind in ("gal_lora", "gal_m", "gal_v"):
            live = np.broadcast_to(gal, got.shape) != 0
        elif kind in ("local_lora", "local_m", "local_v"):
            live = np.broadcast_to((1.0 - gal)[None] * start[f"local_mask/{path}"], got.shape) != 0
        else:
            continue
        np.testing.assert_array_equal(got[~live], start[k][~live], err_msg=k)
        assert not live.any() or np.any(got[live] != start[k][live]), k


def test_make_train_state_matches_jax_tree():
    j_state = jax.eval_shape(lambda r: j_make_state(j_build_model(CFG), r, N_GROUPS), jax.random.PRNGKey(0))
    t_state = make_train_state(t_build_model(TCFG), torch.Generator().manual_seed(0), N_GROUPS, "cpu")
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in tree_items(jax.tree.map(lambda x: x, j_state))}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree_items(t_state)}
    assert got == want
    assert torch.equal(t_state["local_lora"]["layers"]["wq"]["a"][1], t_state["gal_lora"]["layers"]["wq"]["a"])
    assert all(float(x.sum()) == 0 for x in (t_state["local_mask"]["layers"]["wq"]["b"], t_state["step"]))


CACHE_LEN, DECODE_POSITIONS = 24, (16, 17)
_REFS = {}  # the JAX side of the step tests, by arch (see _jax_reference)


def _reference(world):
    """JAX's run of a world as numpy leaves (``'<what>/<path>'``): its
    params, state and batch; 3 jitted train steps (the losses and the states
    after steps 1 and 3); the prefill step's last logits and cache on the
    GAL LoRA; 2 greedy decode steps (each one's token and logits)."""
    model, params, state, batch = world
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {f"{what}/{k}": v for what, tree in (("params", params), ("state", state), ("batch", batch))
           for k, v in _flat_np(tree).items()}
    j_step = jax.jit(j_train_step(model, N_GROUPS, learning_rate=LR))
    j_s, losses = state, []
    for t in (1, 2, 3):
        j_s, m = j_step(params, j_s, jbatch)
        losses.append(float(m["loss"]))
        if t in (1, 3):
            out.update({f"state{t}/{k}": v for k, v in _flat_np(j_s).items()})
    out["losses"] = np.asarray(losses)
    lora = state["gal_lora"]
    j_logits, j_cache = jax.jit(j_prefill_step(model, CACHE_LEN))(params, lora, jbatch)
    out["prefill"] = np.asarray(j_logits)
    out.update({f"cache/{k}": np.asarray(v) for k, v in j_cache.items()})
    j_dec = jax.jit(j_decode_step(model))
    token = np.argmax(np.asarray(j_logits), -1).astype(np.int32)  # (B, 1)
    for j, pos in enumerate(DECODE_POSITIONS):
        j_logits, j_cache = j_dec(params, lora, jnp.asarray(token), j_cache, jnp.int32(pos))
        out[f"token{j}"], out[f"decode{j}"] = token, np.asarray(j_logits)
        token = np.argmax(np.asarray(j_logits), -1).astype(np.int32)
    return out


def _child_reference(arch):
    """:func:`_reference` of ``arch``'s world, in the child process that
    :func:`_jax_reference` starts."""
    return _reference(_jax_world(arch))


def _jax_reference(arch, tmp_dir):
    """:func:`_reference` of ``arch``'s world, once a process. The reduced
    families' JAX programs are compiled in a child process: a pytest worker
    keeps every XLA:CPU executable it compiles, each holding memory maps of
    its code, and these four steps of three models pushed a worker of the
    full run past the kernel's per-process limit (``vm.max_map_count``),
    where XLA segfaults."""
    if arch not in _REFS:
        _REFS[arch] = (_reference(_jax_world(arch)) if arch == "tiny-lm" else
                       jax_in_child("test_torch_launch", "_child_reference", arch, out=tmp_dir / f"{arch}.npz"))
    return _REFS[arch]


def _part(ref, what):
    return {k[len(what) + 1:]: v for k, v in ref.items() if k.startswith(what + "/")}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_train_step_matches_jax(arch, steps, tmp_path):
    ref = _jax_reference(arch, tmp_path)
    tcfg = _tcfg(ARCH_CFGS[arch])
    t_params = params_from_numpy(unflatten_dict(_part(ref, "params")), tcfg, "cpu")
    t_state = _torch_tree(_part(ref, "state"))
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in _part(ref, "batch").items()}
    t_step = build_train_step(t_build_model(tcfg), N_GROUPS, learning_rate=LR)
    t_s, t_losses = t_state, []
    for _ in range(steps):
        t_s, m = t_step(t_params, t_s, t_batch)
        t_losses.append(float(m["loss"]))
    np.testing.assert_allclose(t_losses, ref["losses"][:steps], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    want = _part(ref, f"state{steps}")
    got = {k: v.numpy() for k, v in tree_items(t_s)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    # frozen entries bit for bit: gal_* off the GAL layer, local_* on it
    # (every client group)
    check_frozen(got, {k: v.numpy() for k, v in tree_items(t_state)})
    loc_b = next(v for k, v in got.items() if k.startswith("local_lora/") and k.endswith("/b"))
    assert np.max(np.abs(loc_b[0] - loc_b[1])) > 0.0  # client groups train apart
    assert int(got["step"]) == steps


@pytest.mark.parametrize("arch", list(ARCH_CFGS))
def test_prefill_and_decode_steps_match_jax(arch, tmp_path):
    ref = _jax_reference(arch, tmp_path)
    tcfg = _tcfg(ARCH_CFGS[arch])
    t_params = params_from_numpy(unflatten_dict(_part(ref, "params")), tcfg, "cpu")
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in _part(ref, "batch").items()}
    t_lora = lora_from_numpy(unflatten_dict(_part(ref, "state/gal_lora")), "cpu")
    t_model = t_build_model(tcfg)
    t_logits, t_cache = build_prefill_step(t_model, CACHE_LEN)(t_params, t_lora, t_batch)
    np.testing.assert_allclose(t_logits.numpy(), ref["prefill"], atol=SERVE_ATOL, rtol=SERVE_RTOL)
    j_cache = _part(ref, "cache")
    assert sorted(t_cache) == sorted(j_cache)
    for k in j_cache:
        np.testing.assert_allclose(t_cache[k].numpy(), j_cache[k], atol=SERVE_ATOL, rtol=SERVE_RTOL, err_msg=k)
    t_dec = build_decode_step(t_model)
    token = np.argmax(ref["prefill"], -1).astype(np.int32)  # (B, 1)
    for j, pos in enumerate(DECODE_POSITIONS):
        np.testing.assert_array_equal(token, ref[f"token{j}"])
        t_logits, t_cache = t_dec(t_params, t_lora, torch.from_numpy(token), t_cache, pos)
        np.testing.assert_allclose(t_logits.numpy(), ref[f"decode{j}"], atol=SERVE_ATOL, rtol=SERVE_RTOL)
        token = np.argmax(ref[f"decode{j}"], -1).astype(np.int32)


# --- spec tables -----------------------------------------------------------

MESHES = {
    "pod1": {"data": 16, "model": 16},
    "pod2": {"pod": 2, "data": 16, "model": 16},
}


def _j_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _port_shapes(arch):
    """The port's params, LoRA and decode cache of ``arch`` at full size
    (shapes only, under FakeTensorMode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = t_build_model(T_ARCHS[arch])
    with FakeTensorMode():
        gen = torch.Generator()
        params = model.init_params(gen, "cpu")
        lora = model.init_lora(gen, "cpu")
        cache = None
        if model.supports(T_SHAPES["decode_32k"]):
            cache = model.init_cache(128, 1024, "cpu")
    shape = lambda t: {k: tuple(v.shape) for k, v in tree_items(t)}  # noqa: E731
    return shape(params), shape(lora), None if cache is None else shape(cache)


def _jax_shapes(arch):
    model = j_build_model(J_ARCHS[arch])
    rng = jax.random.PRNGKey(0)
    shape = lambda t: {k: tuple(v.shape) for k, v in tree_items(jax.tree.map(lambda x: x, t))}  # noqa: E731
    params = jax.eval_shape(model.init_params, rng)
    lora = jax.eval_shape(model.init_lora, rng)
    cache = None
    if model.supports(J_SHAPES["decode_32k"]):
        cache = jax.eval_shape(lambda: model.init_cache(128, 1024))
    return shape(params), shape(lora), None if cache is None else shape(cache)


class _Leaf:
    """A stand-in leaf with a shape (both packages' spec functions read only
    ``.shape`` and ``.ndim``)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


def _same(t_spec, j_spec, what):
    assert tuple(t_spec) == tuple(j_spec), (what, t_spec, j_spec)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_spec_tables_match_jax(arch):
    j_params, j_lora, j_cache = _jax_shapes(arch)
    t_params, t_lora, t_cache = _port_shapes(arch)
    assert t_params == j_params and t_lora == j_lora and t_cache == j_cache
    cfg_j, cfg_t = J_ARCHS[arch], T_ARCHS[arch]
    dp_pod1, dp_pod2 = ("data",), ("pod", "data")
    for mesh_name, sizes in MESHES.items():
        jm = _j_mesh(sizes)
        dp = dp_pod2 if "pod" in sizes else dp_pod1
        dp_size = 32 if "pod" in sizes else 16

        def check(j_fn, t_fn, shapes, what):
            for path, shape in shapes.items():
                leaf = _Leaf(shape)
                j_spec, t_spec = j_fn(path, leaf), t_fn(path, leaf)
                _same(t_spec, j_spec, (what, path))
                _same(t_shd._fit(t_shd._restrict(t_spec, sizes), leaf, sizes),
                      j_shd._fit(j_shd._restrict(j_spec, jm), leaf, jm), (what, "fit", mesh_name, path))

        for tp in (False, True):
            check(lambda p, l: j_shd.base_param_spec(p, l, 16, tp), lambda p, l: t_shd.base_param_spec(p, l, 16, tp),
                  j_params, f"params tp={tp}")
        check(j_shd.lora_spec, t_shd.lora_spec, j_lora, "lora")
        local = {k: (16,) + s for k, s in j_lora.items()}
        check(lambda p, l: j_shd.lora_spec(p, l, client_axis=dp), lambda p, l: t_shd.lora_spec(p, l, client_axis=dp),
              local, "local lora")
        for shape_name in J_SHAPES:
            j_specs = j_build_model(cfg_j).input_specs(J_SHAPES[shape_name])
            t_specs = t_build_model(cfg_t).input_specs(T_SHAPES[shape_name])
            assert {k: tuple(v.shape) for k, v in t_specs.items()} == {k: tuple(v.shape) for k, v in j_specs.items()}
            check(lambda p, l: j_shd.batch_spec(p, l, dp, dp_size), lambda p, l: t_shd.batch_spec(p, l, dp, dp_size),
                  {k: tuple(v.shape) for k, v in j_specs.items()}, f"batch {shape_name}")
        if j_cache is not None:
            check(lambda p, l: j_shd.cache_spec(p, l, dp, cfg_j, dp_size),
                  lambda p, l: t_shd.cache_spec(p, l, dp, cfg_t, dp_size), j_cache, "cache")


def test_fit_falls_back_where_jax_does():
    """mamba2's vocab 50280 does not tile 16 ways: a replicated embed;
    granite's 40 experts do not either: tensor parallel within experts."""
    sizes = MESHES["pod1"]
    embed = _Leaf((50280, 2048))
    spec = t_shd.base_param_spec("embed", embed)
    assert tuple(spec) == ("model", None) and tuple(t_shd._fit(spec, embed, sizes)) == (None, None)
    gate = _Leaf((32, 40, 1536, 512))
    assert tuple(t_shd.base_param_spec("layers/e_gate", gate)) == (None, None, None, "model")
    assert tuple(t_shd.base_param_spec("layers/e_down", gate)) == (None, None, "model", None)
    assert tuple(t_shd.base_param_spec("layers/e_gate", gate, moe_token_parallel=True)) == (None,) * 4
    # one name left of ("pod", "data"): the name alone, as JAX's PartitionSpec keeps it
    assert tuple(t_shd._restrict(t_shd.P(("pod", "data"), None, "model"), sizes)) == ("data", None, "model")


def test_placements_of_specs():
    """A spec entry shards its tensor dim on each mesh dim it names (a
    ("pod", "data") entry on both, in order); an axis named twice is
    refused, as JAX's NamedSharding refuses it."""
    from torch.distributed.tensor import Replicate, Shard

    pod2 = MESHES["pod2"]
    assert t_shd.placements(t_shd.P(("pod", "data"), None, "model"), pod2) == (Shard(0), Shard(0), Shard(2))
    assert t_shd.placements(t_shd.P(None, "model"), MESHES["pod1"]) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="named twice"):
        t_shd.placements(t_shd.P(("data", "model"), "model"), MESHES["pod1"])


# --- analysis ----------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_analysis_matches_jax(arch):
    cfg_j, cfg_t = J_ARCHS[arch], T_ARCHS[arch]
    assert t_ana.active_param_fraction(cfg_t) == j_ana.active_param_fraction(cfg_j)
    n = j_tree_bytes(jax.eval_shape(j_build_model(cfg_j).init_params, jax.random.PRNGKey(0))) // 2
    for kind in ("train", "prefill", "decode"):
        assert t_ana.model_flops(cfg_t, n, n // 3, 4096, kind) == j_ana.model_flops(cfg_j, n, n // 3, 4096, kind)
    for kw in (dict(hlo_flops=3e15, hlo_bytes=2e11, coll_bytes=5e9, chips=256),
               dict(hlo_flops=1e12, hlo_bytes=9e12, coll_bytes=1e9, chips=512, per_device=False)):
        assert t_ana.roofline_terms(**kw, hw=tconfig.TPU_V5E) == j_ana.roofline_terms(**kw, hw=J_TPU_V5E)
    # the port's default is the card: H100 SXM's rates
    r = t_ana.roofline_terms(hlo_flops=989e12, hlo_bytes=3.35e12, coll_bytes=0.0, chips=1)
    assert r["compute_s"] == pytest.approx(1.0) and r["memory_s"] == pytest.approx(1.0)


# --- sharding_ctx --------------------------------------------------------------


def test_seq_parallel_without_a_mesh_is_the_same_forward(world):
    _, params, state, batch = world
    t_params, _, t_batch = _port_inputs(world)
    lora = lora_from_numpy(jax.tree.map(np.asarray, state["gal_lora"]), "cpu")
    base = t_build_model(TCFG).forward(t_params, lora, t_batch)[0]
    sp = t_build_model(dataclasses.replace(TCFG, seq_parallel=True))
    sharding_ctx.set_mesh_axes(("data",), enabled=True)
    try:
        out = sp.forward(t_params, lora, t_batch)[0]
    finally:
        sharding_ctx.disable()
    assert torch.equal(out, base)
    x = torch.randn(2, 3, 4)
    assert sharding_ctx.constrain(x, ("dp", "model", None)) is x
    assert sharding_ctx.replicate_partial(x) is x and sharding_ctx.unshard_unless(x, -1, 3) is x


# --- examples ----------------------------------------------------------------


@pytest.mark.parametrize("cmd", [
    ["examples/torch_federated_finetune.py", "--steps", "2", "--device", "cpu"],
    ["examples/torch_serve_batch.py", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
])
def test_examples_run_on_the_cpu(cmd, tmp_path):
    extra = ["--ckpt-dir", str(tmp_path)] if "finetune" in cmd[0] else []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *cmd, *extra], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    if extra:
        assert "loss=" in out.stdout and list(tmp_path.glob("ckpt_2.npz"))
    else:
        assert "seq 1:" in out.stdout


def test_train_launcher_host_demo_and_no_card(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train``: ``--host-demo`` trains the
    reduced configuration on the CPU at the JAX demo sizes and saves the GAL
    LoRA; without a card and without ``--device cpu`` it fails with the
    port's no-device error rather than running on the CPU."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train

    state = train.main(["--arch", "qwen2-0.5b", "--host-demo", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert int(state["step"]) == 1 and state["local_lora"]["layers"]["wq"]["a"].shape[0] == 4
    saved = load_checkpoint(str(tmp_path / "ckpt_1.npz"))
    assert torch.equal(torch.as_tensor(np.asarray(saved["gal_lora"]["layers"]["wq"]["b"])),
                       state["gal_lora"]["layers"]["wq"]["b"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen2-0.5b", "--steps", "1"])
