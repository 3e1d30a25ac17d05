"""The FibecFed train step on DTensors over a gloo mesh, against the same
step without a mesh (``repro_torch.launch.steps``, placed by
``repro_torch.launch.shardings``).

For each mesh ``(data, model)`` in (2, 1), (1, 2) and (2, 2) with the
tiny-lm of ``tests/test_distributed.py``, (1, 2) with reduced
granite-moe-3b-a800m at 4 experts (expert parallel) and at 3 (tensor
parallel within each expert), (1, 2) and (2, 2) with reduced mamba2-1.3b
(8 SSM heads), zamba2-7b (8 SSM heads, a shared block of 4 attention
heads) and whisper-large-v3 (4 heads; its batch carries frame
embeddings), and (1, 2) with whisper at 3 heads and mamba2 at 3 SSM heads
(heads that do not split over 2 ranks: the gathered route), the test
spawns ``data * model`` ranks
(``torch.multiprocessing`` "spawn", ``tests/torch_launch_rank.py``, which
imports the port only) on gloo over a ``FileStore`` under ``tmp_path``,
each child joined with its own timeout. Every rank places the same seeded
params, state and batch, runs 2 train steps (2 client groups: one a data
rank on (2, ·)), and rank 0 writes the gathered losses and state. They equal the
no-mesh step's within atol 1e-6 / rtol 1e-5: a data axis moves the GAL
gradient's client sum into an all-reduce, a model axis splits the
projections' sums across ranks, both f32 orderings only (the SSM, hybrid
and encoder-decoder worlds: see ``ADAM_EPS_REGIME``); the frozen entries
(where the GAL and local masks are 0) hold bit for bit. On a model axis of
2 each rank of the SSM and hybrid models runs its SSD scans on nh / 2
heads (the shapes reaching ``models.ssm.ssd_chunked``). Then the prefill
step and two decode steps on the no-mesh run's trained GAL LoRA: rank 0's
client rows equal the no-mesh logits at ``test_torch_serve.py``'s atol
2e-5 / rtol 1e-4.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores: no thread pool each

import numpy as np

import torch_launch_rank as ranks
from repro_torch.config import ModelConfig
from repro_torch.configs import ARCHS
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step, make_train_state
from repro_torch.lora import gal_mask_tree, lora_num_logical_layers
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_items, tree_map

CFG = ModelConfig(
    name="tiny-lm", family="dense", num_layers=2, d_model=32, num_heads=2,
    num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, dtype="float32",
    lora_rank=2, max_seq_len=64,
)
N_GROUPS, STEPS, LR = 2, 2, 1e-3
PROMPT_LEN, CACHE_LEN = 16, 20
ATOL, RTOL = 1e-6, 1e-5
SERVE_ATOL, SERVE_RTOL = 2e-5, 1e-4  # test_torch_serve.py's
JOIN_S = 240  # each child's own join timeout
# Adam moves an entry by lr·g/(|g| + 1e-8): where a step's gradient is
# below ADAM_EPS_REGIME (100 eps) but not 0 (attention keys' gradients
# cancel over the queries to 1e-8-1e-7 in these worlds), an f32 reordering
# of g moves the entry by up to lr·|dg|/1e-8. Such entries of the SSM,
# hybrid and encoder-decoder worlds are held to the largest move Adam
# makes, STEPS·lr; their moments and every other entry at ATOL / RTOL.
ADAM_EPS_REGIME = 1e-6


GRANITE = ARCHS["granite-moe-3b-a800m"].reduced()  # 2 layers, d 128, 4 experts top-2
WHISPER = ARCHS["whisper-large-v3"].reduced()  # 2 + 2 layers, d 128, 4 heads, 16 frames
CFGS = {
    "dense": CFG,
    # 4 experts on 2 model ranks: expert parallel
    "moe_ep": GRANITE,
    # 3 experts do not tile 2 ranks: tensor parallel within each expert
    "moe_tp": dataclasses.replace(GRANITE, moe=dataclasses.replace(GRANITE.moe, num_experts=3)),
    "ssm": ARCHS["mamba2-1.3b"].reduced(),  # 2 layers, d 128, 8 heads of 32, state 16
    "hybrid": ARCHS["zamba2-7b"].reduced(),  # 2 Mamba2 layers of 8 heads, the shared block once
    "audio": WHISPER,
    # heads that do not split over 2 ranks: gathered before attention or the scan
    "audio_3heads": dataclasses.replace(WHISPER, num_heads=3, num_kv_heads=3),
    "ssm_3heads": ARCHS["mamba2-1.3b"].reduced(d_model=48),  # d_inner 96: 3 heads of 32
}
_WORLDS = {}
EXACT_ADAM = ("dense", "moe_ep", "moe_tp")  # worlds held at ATOL / RTOL on every entry


def _world(name):
    """Seeded params, a state with b off zero, GAL layer 0, local masks of
    ones, a batch; and the no-mesh run of STEPS steps on them, then its
    prefill and two decode steps."""
    if name in _WORLDS:
        return _WORLDS[name]
    cfg = CFGS[name]
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init_params(g, "cpu")
    state = make_train_state(model, g, N_GROUPS, "cpu")
    for k in ("gal_lora", "local_lora"):
        state[k] = tree_map(lambda x: x + 0.02 * torch.randn(x.shape, generator=g), state[k])
    gal = np.zeros(lora_num_logical_layers(cfg), bool)
    gal[0] = True
    state["gal_mask"] = gal_mask_tree(cfg, state["gal_lora"], gal)
    state["local_mask"] = tree_map(torch.ones_like, state["local_mask"])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, PROMPT_LEN), generator=g)}
    if cfg.family == "audio":
        batch["encoder_embeds"] = torch.randn((4, cfg.encoder_seq_len, cfg.d_model), generator=g)
    step = build_train_step(model, N_GROUPS, learning_rate=LR)
    npd = lambda t: {k: v.numpy() for k, v in tree_items(t)}  # noqa: E731
    s, losses, tiny = state, [], {}
    for _ in range(STEPS):
        m_old = {k: v for k, v in npd(s).items() if k.startswith(("gal_m/", "local_m/"))}
        s, m = step(params, s, batch)
        losses.append(float(m["loss"]))
        for k, v in npd(s).items():
            if k in m_old:  # this step's gradient, from m = 0.9 m + 0.1 g
                lora = k.replace("_m/", "_lora/", 1)
                grad = np.abs(v - 0.9 * m_old[k])
                tiny[lora] = tiny.get(lora, False) | ((grad > 0) & (grad < 0.1 * ADAM_EPS_REGIME))
    decode_tokens = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    logits, cache = build_prefill_step(model, CACHE_LEN)(params, s["gal_lora"], batch)
    served = [logits]
    for j in range(2):
        logits, cache = build_decode_step(model)(params, s["gal_lora"], decode_tokens, cache, PROMPT_LEN + j)
        served.append(logits)
    _WORLDS[name] = dict(name=name, cfg=cfg, params=npd(params), state=npd(state), batch=npd(batch), losses=losses,
                         final=npd(s), decode_tokens=decode_tokens.numpy(), served=torch.cat(served, 1).numpy(),
                         tiny=tiny)
    return _WORLDS[name]


def _spawn(world, data, model, workdir):
    key = (world["name"], data, model)
    if key in _SPAWNED:
        return _SPAWNED[key]
    spec = dict(cfg=world["cfg"], params=world["params"],
                state=world["state"], batch=world["batch"], n_groups=N_GROUPS, lr=LR, steps=STEPS, data=data,
                model=model, out=str(workdir), store=str(workdir / "store"), cache_len=CACHE_LEN,
                prompt_len=PROMPT_LEN, decode_tokens=world["decode_tokens"],
                serve_lora={k[len("gal_lora/"):]: v for k, v in world["final"].items() if k.startswith("gal_lora/")})
    W = data * model
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.main, args=(r, W, spec)) for r in range(W)]
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
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not failed, "\n".join(failed)
    with np.load(os.path.join(workdir, "mesh.npz")) as z:
        out = {k: z[k] for k in z.files}
    out["scans"] = [np.load(workdir / f"scans{r}.npy") for r in range(W)]
    _SPAWNED[key] = out
    return out


_SPAWNED = {}  # (world, data, model) -> what the ranks wrote


def check_frozen(final, start):
    """Every entry a mask freezes holds bit for bit: the GAL tree and its
    moments where the GAL mask is 0, the local tree and its moments where
    (1 - GAL mask) x local mask is 0."""
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


@pytest.mark.parametrize("family,data,model", [("dense", 2, 1), ("dense", 1, 2), ("dense", 2, 2),
                                               ("moe_ep", 1, 2), ("moe_tp", 1, 2),
                                               ("ssm", 1, 2), ("ssm", 2, 2), ("hybrid", 1, 2), ("hybrid", 2, 2),
                                               ("audio", 1, 2), ("audio", 2, 2),
                                               ("audio_3heads", 1, 2), ("ssm_3heads", 1, 2)])
def test_mesh_train_steps_match_the_no_mesh_step(family, data, model, tmp_path):
    world = _world(family)
    out = _spawn(world, data, model, tmp_path)
    np.testing.assert_allclose(out["losses"], world["losses"], atol=ATOL, rtol=RTOL)
    placed = str(out["placements"])
    assert "Shard(dim=0)" in placed  # the local LoRA's client axis on "data"
    if model > 1:
        assert "Shard(dim=2)" in placed  # b of wq/wk/wv sharded like the projection's output
    for k, want in world["final"].items():
        got = out[f"state/{k}"]
        if family in EXACT_ADAM or k not in world["tiny"]:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=k)
            continue
        tiny = world["tiny"][k]
        np.testing.assert_allclose(got[~tiny], want[~tiny], atol=ATOL, rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(got[tiny], want[tiny], atol=STEPS * LR, rtol=0, err_msg=k)
    check_frozen({k: out[f"state/{k}"] for k in world["final"]}, world["state"])
    assert int(out["state/step"]) == STEPS
    # serving on the mesh: rank 0's client rows, prefill and two decode steps
    rows = int(out["rows"])
    assert rows == 4 // data
    np.testing.assert_allclose(out["served"], world["served"][:rows], atol=SERVE_ATOL, rtol=SERVE_RTOL)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_each_rank_scans_its_heads(family, tmp_path):
    """On a model axis of 2 every SSD scan a rank runs (the train steps'
    forward, the prefill) is over nh / 2 heads: the scan is split, not
    replicated."""
    world = _world(family)
    out = _spawn(world, 1, 2, tmp_path)
    nh = world["cfg"].ssm.expand * world["cfg"].d_model // world["cfg"].ssm.head_dim
    for r, scans in enumerate(out["scans"]):
        assert len(scans) >= STEPS * world["cfg"].num_layers, (r, scans)
        assert set(scans[:, 2].tolist()) == {nh // 2}, (r, scans)
        assert set(scans[:, 3].tolist()) == {world["cfg"].ssm.head_dim}, (r, scans)
