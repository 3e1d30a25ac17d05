#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one card.

Run from the repository root with ``python3 chip_smoke.py``. It needs a CUDA
device and exits non-zero without one, or if any phase fails:

1. device: the card's name and power limit;
2. build: compile the hand-written CUDA sources from ``src/repro_torch``, one
   ``nvcc`` per source, all started together; B1-B3's are waited for here,
   the others compile under phases 3-5 and are waited for before phase 5b;
   each source's compile seconds, and each kernel's registers, shared
   memory and spills as ``ptxas`` reports them;
3. kernels against their plain PyTorch versions, on the card, at every LoRA
   leaf shape of full qwen2-0.5b, bit for bit: masked AdamW/SGD (B1/B2) per
   client and stacked over 4 clients with per-client scalars, moments f32
   and bf16; B1 and B2 over whole LoRA trees (one launch per tree: f32 and
   mixed bf16 leaves and moments, dense and masked leaves, lr as a number
   and as a tensor); fake compression (B3) over whole trees (one launch per
   upload) in every mode, f32 and bf16, one client and stacked, with a GAL
   (L, 1, 1), a shared and a per-client mask, ties, an all-zero row, a
   short last group and rows longer than the kernel's shared memory; then
   their times in the main paths' configurations (device times from CUDA
   graphs over inputs larger than the L2);
4. the loop engine at full width: FibecFed (adamw, fused kernels) for 2
   rounds and FedAvg+LoRA (sgd, fused) for 1 round on qwen2-0.5b (24
   layers, d 896, vocab 151936, bf16, seeded torch init);
5. the JAX package's default path: ``make_runner("fibecfed", ...)`` with no
   ``engine=`` (the vectorized engine), adamw, fused, init and 2 rounds;
   its Fisher difficulty scores held to the loop engine's, batch by batch;
5b. the public kernel entry point ``repro_torch.kernels.ops`` on that run's
   own data: the Fisher-diagonal update (B4) over a client's FIM tree and
   over all 8 clients' stacked, bit for bit; the neuron-masked LoRA product
   (B5) and its gather-packed form (B6) on the clients' LoRA and neuron
   masks, and the multi-adapter product (B7) over the 8 clients' adapters,
   within a stated tolerance of their plain versions; every kernel again at
   shapes off any tile grid, and B5/B6 at ranks on both single-adapter
   kernels (1, 8, 16 with a and b in shared memory, 64 from L2), widths 1,
   128 and 896, masks keeping no column, every column and half, a K with
   no 16-byte rows, x off a 16-byte boundary and more row tiles than a
   block's ring holds; B6 with inf and nan in b's frozen columns (exact
   zeros there); B7 with a batch skewed to one adapter, adapters with no
   row, every row out of range, every row on adapter 0 (B5's bits), and 64
   random wq-shaped adapters (the SGMV kernel at 4096 rows, the split path
   at 1000 and at rank 64), its on-device plan held to its plain twin;
   B7's few-row path on the clients' adapters of every target at 1, 8
   (a decode step), 33 and 64 rows; that the main path's widths take the
   persistent B5 kernel, B7's SGMV kernel and, at few rows, its few-row
   path; then their times (B6 as the whole call, also in a CUDA graph of
   wrapper calls) and shares of the bound;
5c. the public entry point's attention and state-space kernels:
   ``flash_attention`` (B8) at qwen2-0.5b's attention width (14 heads, 2 KV
   heads, D 64, bf16) on (i) the q, k, v that layer 0 of the vectorized
   run's model computes on one client's batch, (ii) S 4096 causal, (iii)
   S 16384 causal with the model's 8192-token window (checked in slices
   of query rows), (iv) f32, ragged S 2000, window 1000, D 128; and
   ``ssd_chunk_intra`` (B9) at mamba2-1.3b's widths (S 2048 in chunks of
   128, 64 heads: 1024 groups, head_dim 64, state 128) in f32 and bf16,
   with b and c shared by the heads and the Mamba2 initializer's decays,
   plus the JAX tests' small shapes and Q, hd and N off the kernel's tiles
   (a in f32 and bf16); B8 at stablelm-3b's head_dim 80 (32 heads: bf16
   4x1024 under the 8192 window, f32 S 2000 window 1000) and at zamba2-7b's
   head_dim 112 (32 heads: bf16 4x1024 causal, f32 S 2000 window 1000); B9
   at zamba2-7b's 4x1024 (112 heads sharing b and c, head_dim 64, state 64;
   f32 and bf16) and at mamba2-1.3b's serve prefill (4x1024, 64 heads
   sharing b and c, bf16) in the model's layout (x (B, S, nh, hd) and b, c
   column slices of the conv's output, read in place), all of these on the
   TMA route (none counted by ``ssd_chunk.copy_route_launches``); each within a
   stated tolerance of its plain version; then their times beside their bounds and shares of them and,
   for B8 (bf16 on the tensor cores, f32 on the CUDA cores), its TFLOP/s
   and ``scaled_dot_product_attention``'s time;
5d. serving at full width: ``repro_torch.serve.ServeEngine`` on the
   vectorized run's global LoRA and three of its clients' adapters (4
   adapters), 12 requests of 128- and 1024-token prompts, budgets 8 and 16,
   8 slots, a 1152-token cache (ring layout), greedy, one request stopped by
   an EOS from its own greedy stream, one sampled (temperature 0.8): prefill
   takes B8 for the prompt attention and B7 (SGMV) for the per-slot LoRA
   delta, decode B7's few-row path; each completion held to the training forward
   over prompt + emitted tokens (no kernel, no cache) at every emitted
   position within a stated tolerance, greedy tokens off its argmax only at
   a near-tie, with two controls (the LoRA left out, the next adapter) read
   on the same measure; a second run with telemetry gives the same tokens
   bit for bit, its spans nest and its counters equal the completions;
   per-group prefill, decode-step, TTFT and tokens/s times, the device's
   busy share of a decode step and of the first prefill group under
   ``torch.profiler``; B7 (each LoRA target) and B8 held against their
   plain versions at every shape the path gave them, and B7 at the decode
   shape and B8 at the first prefill group's beside their bounds;
5e. phase 5's vectorized run again with ``telemetry=``: its round 0 equals
   phase 5's bit for bit (stats, comm bytes, global LoRA);
6. compressed uploads (top-k 0.1, int8 values, error feedback) with
   per-client ranks, random_select/sgd (fused), 1 round on each engine from
   the same seed: equal comm bytes, equal to the wire format recomputed from the GAL mask and ranks,
   global updates that agree, low-rank clients' beyond-rank components
   untouched;
m. the sharded engine (``engine="sharded"``) on a 1-rank NCCL process
   group over this card (``make_client_mesh()``): (i) phase 5's
   configuration, init and 2 rounds, equal to phase 5's run bit for bit
   (orders, GAL layers, neuron masks, losses, global LoRA, stacked client
   state, comm bytes), B1 once per step; (ii) phase 6's compressed round,
   equal to phase 6's vectorized run bit for bit, B2 once per step and B3
   once per upload. More ranks need more cards: their semantics are held on
   the CPU over gloo (``tests/test_torch_sharded.py``);
7. the FibecFed loop round of phase 4 unfused, which must agree with the
   fused one (loss rel 1e-6, global LoRA atol 1e-6: the same arithmetic in
   the same order); the unfused runner restores phase 4's snapshot taken
   after its init (the init runs no optimizer), so its orders, masks and
   GAL layers are phase 4's without a second init;
k. the async engine on phase 4's world (FibecFed/AdamW fused unless said):
   (i) the degenerate configuration (uniform scenario, the cohort as
   buffer), init and 2 merges, against phase 4's loop run: the same orders,
   GAL layers and cohorts, each round's client LoRA within phase 7's 1e-6
   and its loss within rel 1e-6 (round 1 starts from phase 4's round-0
   global, put in place of the async merge 0), each merge within f32
   reassociation of the loop's FedAvg, the final global within phase 6's
   limits, the same comm bytes (and the wire format's), staleness and
   drops 0, B1 once per step; (ii) the straggler scenario, its init
   restored from k(i)'s (the same world and init settings),
   with every adaptive policy (delta merges at server lr 0.8, cutoff 2,
   adaptive buffer and steps, sampling bias 2), 4 merges with telemetry:
   finite losses, staleness within the cutoff and above 0 somewhere, the
   buffer within [1, 2], the virtual clock advancing, the slowest client
   planned ceil(n/4) batches, each merge's comm bytes its completions',
   the virtual upload and dispatch spans adding up to them, B1 once per
   valid step of every local round; (iii) random_select/SGD with the
   constrained scenario's ranks and phase 6's compression, 2 merges flat
   and through two edges: equal decisions and bytes, globals within phase
   6's limits, B2 once per valid step and B3 once per upload, low-rank
   clients untouched beyond their rank, the wire format's bytes;
l. client stores and run checkpoints (on phase 4's world): (i)
   phase 4's loop run and phase 5's vectorized run each saved a run
   snapshot (``save_run_checkpoint``) after round 0, and k(ii)'s straggler
   run after merge 2 (clients in flight, their trained payloads on the
   scheduler's heap), outside the timed windows; a freshly built runner
   restores each into the card's memory and runs the remaining rounds or
   merges: the loop and vectorized runs bit for bit the uninterrupted ones
   (global LoRA, every loss, the comm-byte integers), the async run with
   identical accounting (virtual time, staleness, merged, dropped and
   stale-dropped clients, bytes) and its global LoRA within atol 5e-5 /
   rtol 1e-4; (ii) phase 5's configuration launched through
   ``FederationService`` on an ``OutOfCoreStore`` with 2 hot slots (below
   the cohort of 4), a snapshot every round, 2 rounds: phase 5's comm
   bytes and its losses within ``ENGINE_LOSS_RTOL``; the curriculum orders
   and GAL layers of phase 4's loop run (an out-of-core init scores each
   client on its own, as the loop engine does, where phase 5's scores them
   under the vmap and may order near-tied batches apart), and where the
   orders equal phase 5's, its global within phase 6's limits of phase
   5's; an in-memory twin of phase 5's configuration (its init restored
   from phase 5's snapshot after init) given those decisions equal to it
   bit for bit; a cold file for every client, the peak memory
   beside phase 5's; then a fresh runner on a fresh store directory restores
   ``round_00000001`` (its hardlinked cold files included) and reruns
   round 1 bit for bit the service's; each part's restore s, round or
   merge s after the restore, snapshot bytes on disk and B1 launches;
f. the Mamba2 family at full mamba2-1.3b width (its 48 layers cut to 8,
   d 2048, 64 heads of 64, state 128, chunk 128, bf16, seeded torch init): the default
   vectorized FibecFed/AdamW (stacked B1, no vmap fallback to a loop) on
   the keyword task over 4 clients (8 ran out of memory at full depth) for 1 round,
   then ``ServeEngine`` on its global LoRA and three clients' adapters
   with phase 5d's 12 requests (one sampled), 8 slots, a cache length
   below the prompts that clamps no budget: prefill takes B9 for the
   intra-chunk scan (the heads sharing b and c) and B7 for the per-slot
   LoRA of in_proj and out_proj (the split path), decode B7's few-row path; each
   completion held to the f32 training forward within 1.5 times the plain
   bf16 forward's own distance from it (which the phase measures), with
   phase 5d's two controls; a
   telemetry run gives the same tokens and times the path (prefill ms per
   group, decode-step ms, TTFT, useful tokens/s, peak memory, the busy
   share under ``torch.profiler``); B9 and B7 held against their plain
   versions at every shape the path gave them, and timed at the 4x1024
   group's and the decode shape beside their bounds;
g. the lossless criteria on the card: the loop FibecFed runner with masked
   SGD (B2 per client step) and ``gal_fraction=None, sparse_ratio=None`` at
   qwen2-0.5b's width cut to 4 layers, 4 clients, Lanczos 8, one round: each
   client's Ritz values, Lipschitz estimate and fraction, the GAL count from
   the fractions and the neuron masks' ρ;
h. the rest of the dense family at full width (bf16, seeded init):
   qwen3-0.6b (its 28 layers cut to 8, d 1024, qk-norm) trained 2 rounds on the
   vectorized engine and served with phase 5d's 12 requests; stablelm-3b
   (parallel residual, head_dim 80: B8 at D 80) and chatglm3-6b (2 KV
   heads), each at full width cut to 8 layers, served with 4 requests each over 4 seeded adapters; every
   completion held to its training forward by phase 5d's oracle and
   controls, B8 against its plain version at every prefill group's shape;
   FedPrompt on qwen2-0.5b (1 round, evaluate, its exact comm bytes, the
   prefixed bf16 forward against its f32 twin); each decode step's time,
   busy share and B7 share for phases 5d, f, h and i, and B7's and B8's
   shares of the first prefill group's kernel time (every prefill shape whose
   adapters do not stage takes the split path, timed beside the L2 kernel
   it replaced and two ``torch.bmm`` calls);
i. the MoE family and the zamba2 hybrid at full width (bf16, seeded init):
   granite-moe-3b-a800m (32 layers, 40 experts top-8) trained 2 rounds on
   the vectorized engine (no vmap fallback) and served with phase 5d's 12
   requests; llama4-maverick-400b-a17b (128 experts top-1 and a shared
   expert) cut to one layer and served 4 requests; both held by the MoE
   oracle (``MOE_LOGIT_REL``: prefill's last logits against the training
   forward over the group's prompts, each decode step against the same
   step teacher-forced on a copy of its cache, B7 and B8 plain; phase 5d's
   two controls; the (token, expert) assignments that differ counted);
   zamba2-7b (its 81 layers cut to 15: 2 applications of the shared block) served with
   5d's 12 requests (B9 on every Mamba layer's prefill, B8 at D 112 on each
   application, B7 on both LoRA groups, the few-row path on decode) and
   held by phase f's oracle; zamba2-7b's width cut to 12 layers trained 1
   round (B1 over the shared block's unstacked LoRA group); B7, B8 and B9
   against their plain versions at every served shape;
j. the last families at full width (bf16, seeded init): whisper-large-v3
   (its 32 + 32 layers cut to 10 + 10) and paligemma-3b (18 layers, 256 prefix rows) served
   with phase 5d's 12 requests, each with its own seeded frame or patch
   embeddings (B8 bidirectional over whisper's 1500 frames and causal over
   its prompt, B8 at D 256 over paligemma's prefix and prompt, B7 on every
   LoRA group, the few-row path on decode), held by phase 5d's oracle with
   a third control (the next request's embeddings); each trained 1 round
   at its width cut to 4 + 4 and 4 layers (B1); roberta-large (24 layers)
   trained 1 round (B1), its Fisher difficulty held to the loop engine's,
   its class accuracy from ``evaluate``; phase 5c also holds and times B8
   at D 256 (paligemma's 4x1280, f32 S 2000) and bidirectional at
   whisper's encoder and roberta's widths;
n. the launch layer at full qwen2-0.5b width: (i) the FibecFed
   train step of ``launch/steps.py`` through ``launch/train.py``'s
   ``init_run`` and ``train_loop`` (GAL on the first 75% of the layers,
   local masks of ones, 4 client groups of a 16 x 128-token batch, 4 steps),
   B1 twice a step (the GAL tree and the local tree), held to the same
   steps with B1's plain version in its place (losses at rel 1e-6, every
   state leaf at phase 7's 1e-6, the frozen entries bit for bit to the
   start); (ii) the prefill step (B8 once a layer) over 4 prompts of 128
   tokens and 8 greedy decode steps, held to the teacher-forced training
   forward at phase 5d's 0.05 of a row's largest |logit|, and B8 against
   its plain version at that shape; (iii) one train step under
   ``launch/prof_stats.py``'s profiler (kernel ms, launches, busy share,
   peak memory) and its counter (flops, bytes written), its model flops
   and their share of the card's bf16 peak, and its roofline terms on
   H100_SXM (``launch/analysis.py``);
o. the launch layer for the SSM, hybrid and encoder-decoder
   families: (i) mamba2-1.3b at 4 layers, zamba2-7b at 6 (one application
   of its shared block) and whisper-large-v3 at 4 + 4, full width, no mesh:
   2 train steps of n's 4 groups x 4 x 128 tokens (B1 twice a step) held to
   the B1-plain twin as n holds its own, then the prefill step (B9 once a
   Mamba2 layer, B8 once an attention over the prompt) over 4 x 128 and 4
   greedy decode steps held to the teacher-forced training forward (mamba2
   and zamba2 by phase f's f32 oracle, whisper at 0.05 of a row's largest
   |logit|), and B8 against its plain version at whisper's prompt shape;
   (ii) the first layer of each kind of the three at 2 layers in f32 run as
   the two ranks of a (1, 2) mesh run it, one after the other on this card:
   the Mamba2 mixer's core on each rank's half of the heads (B9 over nh /
   2 heads in the prefill; a decode step), the attentions on each rank's
   half (B8), recombined as DTensor recombines them (the gated norm's sum of
   squares summed, the out-projections' partial sums added) and held to
   the whole layer: heads and conv windows bit for bit, outputs and states
   within 1e-5 of their largest |value|. The mesh steps themselves run on
   gloo over CPU tensors (``tests/test_torch_launch_mesh.py``): gloo's
   functional all-gather of a CUDA tensor segfaults on torch 2.11;
8. one JSON line listing the kernels; last, the ok line.

The run goes 2-5d, n, o, f, h, i, j: every phase that times the device, each
alone on the card. Then phases k and l(i) run in a second process on the
card (``python3 chip_smoke.py --phases-k-l STATE``, from phase 4's records
and the snapshots of phases 4 and 5), beside 5e, 6, m, 7, g and l(ii) in
this one: all of these check and time nothing on the device, and their
host seconds are taken beside each other. The second process's log follows
l(ii)'s.

Each path of phases 4-6, 5b-5d, m, n, o, k, l, f, g, h, i and j included, is driven with the kernels' launch
counts set to 0 just before it and read just after. Float32 matmuls run in
full f32 (TF32 off for matmuls and cuDNN alike). The end of each phase, with
the seconds since the start, also goes to standard error.
"""
import atexit
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:  # the card's constants have one source: HardwareSpec in the port's config
    from repro_torch.config import H100_SXM
except ImportError:  # run outside the repository: main() refuses to run
    H100_SXM = None
HBM_BYTES_PER_S = H100_SXM and H100_SXM.hbm_bandwidth  # H100 SXM HBM3, 3.35e12 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = H100_SXM and H100_SXM.peak_flops  # H100 SXM bf16 tensor cores, dense, 989e12
L2_BYTES = 50e6  # H100 L2 cache
LEAF_SHAPES = {"a": (24, 896, 8), "b_q_o": (24, 8, 896), "b_k_v": (24, 8, 128)}
K = 4  # the cohort: clients stacked on the vectorized engine's leading axis
MU_SOURCE = "src/repro_torch/kernels/csrc/masked_update.cu"
CP_SOURCE = "src/repro_torch/kernels/csrc/compress.cu"
FD_SOURCE = "src/repro_torch/kernels/csrc/fisher_diag.cu"
SL_SOURCE = "src/repro_torch/kernels/csrc/sparse_lora.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SC_SOURCE = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
KERNELS = {  # name -> what it ports, its source, and its work per element (B1-B3)
    "masked_adamw_update": dict(
        replaces="src/repro/kernels/masked_update.py:156", source=MU_SOURCE,
        bytes_per_elem=32,  # p, g, m, v, mask read; p, m, v written (f32)
        flops_per_elem=14,
    ),
    "masked_adamw_update_stacked": dict(
        replaces="src/repro/kernels/masked_update.py:156", source=MU_SOURCE,
        bytes_per_elem=32, flops_per_elem=14,
    ),
    "masked_sgd_update": dict(
        replaces="src/repro/kernels/masked_update.py:133", source=MU_SOURCE,
        bytes_per_elem=12,  # p, g read; p written (f32, no momentum, no mask)
        flops_per_elem=2,
    ),
    "masked_sgd_update_stacked": dict(
        replaces="src/repro/kernels/masked_update.py:133", source=MU_SOURCE,
        bytes_per_elem=16,  # p, g, mask read; p written (the rank-masked path)
        flops_per_elem=2,
    ),
    "fake_compress": dict(
        replaces="src/repro/kernels/compress.py:56", source=CP_SOURCE,
        # the whole stacked upload: d, r and the per-client mask read, y and
        # the residual written (f32); 16 with a broadcast GAL mask
        bytes_per_elem=20,
        # d + r, abs, compare to the mask; the select's 3 digit passes (shift,
        # compare, count); the top-k/int8 round trip (multiply, round, two
        # clamps, multiply, compare, select, subtract)
        flops_per_elem=20,
    ),
    # B4-B7: phase 5b computes their bytes and flops for the whole call
    "fisher_diag_update": dict(replaces="src/repro/kernels/fisher_diag.py:26", source=FD_SOURCE),
    "sparse_lora_apply": dict(replaces="src/repro/kernels/sparse_lora.py:79", source=SL_SOURCE),
    "sparse_lora_apply_packed": dict(replaces="src/repro/kernels/sparse_lora.py:119", source=SL_SOURCE),
    "batched_sparse_lora_apply": dict(replaces="src/repro/kernels/sparse_lora.py:191", source=SL_SOURCE),
    # B7's few-row path (at most 64 rows: a decode step), two chained launches
    "batched_sparse_lora_few_rows": dict(replaces="src/repro/kernels/sparse_lora.py:191", source=SL_SOURCE),
    # B7's split path (more rows whose adapters do not stage: a wide model's
    # prefill), two chained launches
    "batched_sparse_lora_split": dict(replaces="src/repro/kernels/sparse_lora.py:191", source=SL_SOURCE),
    # B8-B9: phase 5c computes their bytes and flops for the whole call
    "flash_attention": dict(replaces="src/repro/kernels/flash_attention.py:78", source=FA_SOURCE),
    # B8 at head_dim 80 (stablelm-3b): its launches are those of the paths
    # whose every attention has D 80
    "flash_attention_d80": dict(replaces="src/repro/kernels/flash_attention.py:78", source=FA_SOURCE),
    # B8 at head_dim 112 (zamba2-7b's shared attention), likewise
    "flash_attention_d112": dict(replaces="src/repro/kernels/flash_attention.py:78", source=FA_SOURCE),
    # B8 at head_dim 256 (paligemma-3b), likewise
    "flash_attention_d256": dict(replaces="src/repro/kernels/flash_attention.py:78", source=FA_SOURCE),
    "ssd_chunk_intra": dict(replaces="src/repro/kernels/ssd_chunk.py:40", source=SC_SOURCE),
}
# the counts a path reads: name -> (the repro_torch.kernels.ops wrapper, its
# counter); B7's wrapper counts its few-row and split paths apart
COUNTERS = {name: (name, "launches") for name in (
    "masked_adamw_update", "masked_sgd_update", "fake_compress", "fisher_diag_update", "sparse_lora_apply",
    "sparse_lora_apply_packed", "batched_sparse_lora_apply", "flash_attention", "ssd_chunk_intra")}
COUNTERS["batched_sparse_lora_few_rows"] = ("batched_sparse_lora_apply", "few_row_launches")
COUNTERS["batched_sparse_lora_split"] = ("batched_sparse_lora_apply", "split_launches")
LAUNCHED = tuple(COUNTERS)
# Phase 5b: the LoRA layers and row counts it drives. 256 rows are one
# client's batch (4 sequences of 64 tokens); 4096 a batch of 64 such
# sequences. The LoRA products sum in another order than the plain
# version's matmuls, so the two f32 results differ by up to 1e-5 of the
# largest |y| (the sums' scale, not each value's). On top of that, f32
# outputs agree within atol = rtol = 1e-4, and bf16 outputs, which round
# those f32 values, at most one bf16 ulp apart.
OPS_LAYERS = (0, 11, 23)
OPS_ROWS = (256, 4096)
FEW_ROWS = (8, 1, 33, 64)  # B7's few-row cases: a decode step's 8 rows, one, up to the path's 64
LORA_TOL = 1e-4
LORA_ORDER_REL = 1e-5
# the single-adapter kernels' ragged cases: ranks on both of its paths,
# widths of one column, of wk and of wq, and masks keeping no column, every
# column and half of them
LORA_RANKS = (1, 8, 16, 64)
LORA_WIDTHS = (1, 128, 896)
LORA_MASKS = {"zero": 0.0, "one": 1.1, "half": 0.5}
# Phase 5c. B8: an output row is a convex combination of v's rows, and the
# kernel takes the scores, exponentials and sums in another order than the
# plain version, so f32 outputs agree within 1e-5 of the largest |v|; bf16
# outputs round those f32 values, so they may be one bf16 ulp further
# apart. B9: the sums (c·b, the scan of a, M·x) run in other orders; they
# err by a few ulp of their absolute terms and a decay exp(cs_i - cs_j) by
# a few ulp of |cs|, so an output may differ by (1e-5 + 1e-6·max|cs|) times
# the sum of its absolute terms (the plain version on |x|, |b|, |c|).
ATTN_REL = 1e-5
SSD_REL, SSD_CS_REL = 1e-5, 1e-6
ATTN_HEADS = (14, 2, 64)  # qwen2-0.5b: query heads, KV heads, head_dim
D80_HEADS = 32  # stablelm-3b: 32 query and KV heads of 80
D112_HEADS = 32  # zamba2-7b's shared attention: 32 query and KV heads of 112
D256_HEADS = (8, 1)  # paligemma-3b: 8 query heads of 256 over 1 KV head
D256_SHAPE = (4, 1280)  # its serve prefill group: 4 prompts of 1024 tokens after 256 prefix rows
# B8 bidirectional (causal=False) at the encoders' widths: whisper-large-v3's
# encoder (4 requests of 1500 frames, 20 heads of 64: a ragged last tile)
# and roberta-large's (4 sequences of 512 tokens, 16 heads of 64)
BIDIRECTIONAL = {"whisper_encoder": (4, 1500, 20), "roberta": (4, 512, 16)}
ATTN_SLICE = 1024  # query rows per slice of the plain version at S 16384
SSD_WIDTHS = dict(S=2048, chunk=128, nh=64, hd=64, N=128)  # mamba2-1.3b, one sequence
# zamba2-7b's Mamba layers at its 4x1024 serve prefill: 112 heads of 64 sharing b and c, state 64
ZAMBA2_SSD = dict(B=4, S=1024, chunk=128, nh=112, hd=64, N=64)
# mamba2-1.3b's serve prefill group (4 prompts of 1024: 32 rows of 64 heads sharing b and c), bf16, in
# the model's layout as its prefill launches it
SSD_SERVE = dict(B=4, S=1024)
SSD_SMALL = ((128, 64, 32), (128, 128, 128), (64, 32, 16))  # the JAX tests' (Q, hd, N)
# B9 off the main shape: Q, hd and N with and without padding to the kernel's tiles
SSD_RAGGED = tuple((Q, hd, N) for Q in (8, 24, 64, 128) for hd in (4, 20, 64, 128) for N in (1, 5, 128))
COMPRESSION = dict(mode="topk", topk_ratio=0.1, topk_values="int8", error_feedback=True)
RANKS = [8, 8, 4, 4, 8, 8, 2, 8]
# Phase 5 holds the vectorized engine's Fisher difficulty scores to the loop
# engine's, client by client. The engines run the bf16 model as GEMMs of
# other shapes (batched under the vmap over clients), so each layer's
# outputs may round one bf16 ulp (2^-8) apart; over 24 layers the gradients
# drift about sqrt(24)·2^-8 = 0.019 apart, and a score, a sum of squared
# gradients, twice that: 0.038, held at 0.05. A padded sample counted or a
# real one dropped moves a 4-sample batch's score by its share, ~0.25.
# Where the engines order two batches differently, the loop engine's scores
# of the pair must lie within twice the largest gap: a near-tie.
DIFFICULTY_RTOL = 0.05
# Phase 6 compares the two engines, so it takes a preset whose curriculum
# and GAL decisions cannot differ between them: random difficulty (the same
# host draws) and every layer global, no Fisher scores or FIM masks, which
# the bf16 forward can tip at a near-tie (phase 5 shows where).
PHASE6_BASELINE = "random_select"
# Phase 5d: serving at full width. 12 requests over 4 adapters (the
# vectorized run's global LoRA and three of its clients'): (prompt length,
# new-token budget, adapter). Prompts of 128 and 1024 tokens make two shape
# groups; 8 slots and a 1152-token cache (ring layout under the 8192 window)
# make the queued four reuse freed slots. The budgets set the decode depth
# of every serve run (23 steps; a decode step is host-bound, ~40-170 ms),
# which keeps the script inside its time limit.
SERVE_REQUESTS = (
    (1024, 16, 0), (1024, 8, 1), (1024, 16, 2), (1024, 8, 3),
    (128, 8, 0), (128, 16, 1), (128, 8, 2), (128, 16, 3),
    (1024, 8, 1), (1024, 16, 2), (128, 8, 3), (128, 16, 0),
)
SERVE_SLOTS, SERVE_CACHE = 8, 1152
# decode steps timed after the serve runs (the busy share's wall time; the
# runs' own spans give the mean over every step): a host-bound step, ~15-150 ms
SERVE_STEP_ITERS = 8
SERVE_EOS = 5  # stopped by an EOS taken from its own greedy stream
SERVE_SAMPLED, SERVE_TEMPERATURE = 7, 0.8
# Each completion is held to the training forward (``decoder_forward``: no
# kernel, blockwise attention, plain LoRA, no cache) over prompt + emitted
# tokens with the request's own adapter. The served logits differ from it
# by (a) B7, which keeps x@a in f32 and scales once where the plain LoRA
# rounds x@a to bf16 and scales in bf16; (b) B8 and decode attention, which
# sum in other orders than blockwise attention; (c) GEMMs of other shapes
# (8 decode rows, groups of prompts) rounding bf16 outputs apart. Each can
# move a layer's output by one bf16 ulp (2^-8); over 24 layers the hidden
# state drifts about sqrt(24)·2^-8 = 0.02 apart, and a logit, a dot product
# of it with an embedding row, by that share of its row's scale: held at
# 0.05 of the row's largest |logit|. A greedy token may differ from the
# oracle's argmax only where the two lie within that tolerance (a near-tie).
# The same measure against the forward with the LoRA left out, or with the
# next adapter, must read above 1 for every request: else the oracle could
# not fail a served path that dropped or misrouted the per-slot delta.
SERVE_LOGIT_REL = 0.05
# Phase f: the Mamba2 family at full mamba2-1.3b width (SSM_LAYERS of its 48 layers, d 2048,
# 64 heads of 64, state 128, chunk 128, vocab 50280, bf16, seeded torch
# init, LoRA rank 8 on in_proj/out_proj). The default vectorized
# FibecFed/AdamW trains SSM_ROUNDS rounds on phase 4-5's keyword task over
# SSM_CLIENTS clients, a cohort of all of them, with gal_fraction and
# sparse_ratio pinned. Phase 4-5 has 8 clients, but at full depth the stacked Fisher
# difficulty then holds 8 clients x 4 samples of the 48-layer training
# forward and backward at once (its plain SSD keeps (64 heads, 128, 128) f32
# decays for each sample and layer): 73.4 GiB at its peak alone, and out of
# memory after the earlier phases (NVIDIA H100 80GB HBM3). ServeEngine then serves phase 5d's
# 12 requests (no EOS request) on its global LoRA and three clients'
# adapters. An SSM's cache does not grow with the sequence: SSM_CACHE,
# below every prompt, clamps no budget (cached attention would leave the
# 1024-token prompts none). The served logits are held to the training
# forward (plain, no kernel, no cache) in f32: params widened, TF32 off.
# Phase 5d's fixed 0.05 of a row's largest |logit| against the bf16
# forward cannot hold here: 48 Mamba2 layers at a random init amplify a
# change of one bf16 ulp in a layer's output far more than the
# sqrt(48)·2^-8 = 0.027 a sum of independent ulps would give, and the
# plain bf16 forward of a 1024-token sequence lies 0.06-0.075 of a row's
# largest |logit| from the f32 one (NVIDIA H100 80GB HBM3, 700 W). Both
# the served path (B9, B7 with x@a in f32, the recurrent decode, GEMMs of
# other shapes) and the plain bf16 forward round to bf16 at every layer,
# so each is an approximation of the f32 forward. The phase measures the
# floor, the plain bf16 forward's own largest error at the served
# positions, and holds the served path to SSM_FLOOR_RATIO times it: at most
# half again as far from the f32 forward as the training forward is. A
# path that drifts twice as far, or runs a layer in a lower precision,
# fails it. Both controls read the same measure with the LoRA left out and
# with the next adapter, and must read above 1.
SSM_ROUNDS = 1
SSM_CLIENTS = 4
# Phases f, h, i and j at full width run with their depth cut where the
# script's time asks it (each family trained and served at that depth):
# mamba2-1.3b 48 -> 8 layers, qwen3-0.6b 28 -> 8, zamba2-7b served at
# 81 -> 15 (2 applications of the shared block and the tail of 3, as its
# 81 are 13 and 3), whisper-large-v3 served at 32 + 32 -> 10 + 10,
# stablelm-3b (32) and chatglm3-6b (28) served at DENSE_SERVE_LAYERS (cut
# further when phase n came in: 24, 14, 27, 16 + 16 and full depth
# before; at 16, 8, 21, 10 + 10 and full depth the serve oracles' controls
# read 9.6, 2.0, 14.9, 1.6 and 23-28: qwen3's and whisper's, the smallest,
# stay where they are).
# granite-moe-3b-a800m stays at its 32 layers: cut to 16, its MoE oracle
# read 0.990 of the tolerance at a prefill position (0.714 at 32).
SSM_LAYERS = 8
QWEN3_LAYERS = 8
ZAMBA2_SERVE_LAYERS = 15
WHISPER_SERVE_LAYERS = 10
DENSE_SERVE_LAYERS = 8
SSM_CACHE = 64
SSM_FLOOR_RATIO = 1.5
# Phase g: the lossless criteria on the card. The loop runner with masked
# SGD (fused: B2 per client step) and gal_fraction = sparse_ratio = None at
# qwen2-0.5b's width, its depth cut to LOSSLESS_LAYERS layers: a client's
# Lanczos (LOSSLESS_ITERS Hessian-vector products) and Lipschitz probes (4
# more and 5 gradients) are ~LOSSLESS_ITERS + 9 forward-over-reverse passes
# each, and at 24 layers over LOSSLESS_CLIENTS clients they would take a
# large share of the script's time.
LOSSLESS_LAYERS, LOSSLESS_ITERS, LOSSLESS_CLIENTS = 4, 8, 4
# Phase h: stablelm-3b and chatglm3-6b serve these requests (prompt length,
# budget, adapter) on four seeded adapters whose b is drawn from
# N(0, DENSE_B_SCALE²): at rank 8 and LoRA scale 2 that moves a projection's
# output by ~0.3-0.5 of its own scale (x@a sums K values of ~1/8), enough for
# the "LoRA left out" and "next adapter" controls to read above 1. FedPrompt
# trains PROMPT_VECTORS soft-prompt vectors.
DENSE_REQUESTS = ((1024, 16, 0), (1024, 16, 1), (128, 16, 2), (128, 16, 3))
DENSE_B_SCALE = 0.01
PROMPT_VECTORS = 16
# Phase i: the MoE family and the zamba2 hybrid at full width, bf16 from a
# seeded torch init. granite-moe-3b-a800m (32 layers, 40 experts top-8) is
# trained as phase h trains qwen3-0.6b and served with phase 5d's requests;
# llama4-maverick-400b-a17b, cut to LLAMA4_LAYERS layer (one layer's 128
# experts of 5120 x 8192 are 32.2 GB in bf16; the whole model would be
# ~800 GB), is served phase h's DENSE_REQUESTS; zamba2-7b (ZAMBA2_SERVE_LAYERS
# of 81 layers) is served phase 5d's requests, and
# trained at its width cut to ZAMBA2_TRAIN_LAYERS layers (two applications).
#
# The MoE oracle. A decode step routes the 8 slots as one group (capacity
# 2 an expert at granite's 40 experts, top-8), and a prefill group routes
# each prompt in groups of 512 tokens: an expert choice at a near-tie, or a
# queue position at the capacity's edge, can move with a ulp of a hidden
# state, and then a token's FFN takes another expert. So a served logit is
# held to a forward that runs the same network on the same inputs, batched
# as the path batched them: (1) each prefill group's last logits against the
# training forward (no cache) over the group's prompts with its per-slot
# adapters; (2) each decode step against the same step, teacher-forced on a
# copy of the same cache, tokens and positions; in both the kernels (B7, B8)
# replaced by their plain versions on the card. Each at MOE_LOGIT_REL of a
# row's largest |logit| (phase 5d's measure); a greedy token off the
# oracle's argmax only at a near-tie. (3) Phase 5d's two controls on the
# same measures: the LoRA left out and the next adapter, above 1 for every
# request. The (token, expert) assignments that differ between the served
# and the oracle run are counted and printed.
MOE_LOGIT_REL = 0.05
LLAMA4_LAYERS = 1
ZAMBA2_TRAIN_LAYERS = 12
ZAMBA2_CLIENTS = 8
# zamba2-7b's served logits are held to the f32 training forward as phase
# f holds mamba2-1.3b's: within SSM_FLOOR_RATIO times the plain bf16
# forward's own distance from it, measured in the run (deep stacks of a
# random init amplify a ulp as mamba2's do).
HYBRID_FLOOR_RATIO = SSM_FLOOR_RATIO
# Phase j: the last families at full width, bf16 from a seeded torch init.
# whisper-large-v3 (WHISPER_SERVE_LAYERS of 32 encoder and of 32 decoder layers) and paligemma-3b (18
# layers, 256 prefix rows) serve phase 5d's 12 requests, each with its own
# seeded frame (N(0, 1), 1500 x 1280) or patch (N(0, 1), 256 x 2048)
# embeddings, over four seeded adapters (phase h's: b from N(0,
# DENSE_B_SCALE²)), 8 slots, one EOS and one sampled request. whisper's
# cache is phase 5d's 1152 tokens; paligemma's PALIGEMMA_CACHE holds a
# 1024-token prompt's 1280 positions with room for its budget. Each is
# held by phase 5d's oracle (SERVE_LOGIT_REL of a row's largest |logit|
# against the training forward over the prompt, its extras and the emitted
# tokens) and its two controls, plus a third: the forward with the next
# request's extras, above 1 (else the oracle could not fail a path that
# mixed up the requests' frames or patches). Then each trains 1 round on
# the vectorized engine at its width, cut in depth (whisper to
# WHISPER_TRAIN_LAYERS encoder and as many decoder layers, paligemma to
# PALIGEMMA_TRAIN_LAYERS), on the keyword task with seeded extras
# (FAMILY_SAMPLES samples over 8 clients, cohort 4, batch FAMILY_BATCH: the
# Fisher difficulty holds the per-sample gradients of 8 clients' batches at
# once, whisper's of 1500-frame encoders, paligemma's of 320 positions of
# 257216-wide logits). roberta-large (24 layers) trains
# ROBERTA_ROUNDS rounds on the keyword task relabelled to its 2 classes
# (``labels``), its Fisher difficulty held to the loop engine's as phase 5
# holds qwen2-0.5b's.
PALIGEMMA_CACHE = 1408
WHISPER_TRAIN_LAYERS = 4
PALIGEMMA_TRAIN_LAYERS = 4
FAMILY_SAMPLES, FAMILY_BATCH = 64, 2
ROBERTA_ROUNDS = 1
# The two engines' compressed rounds differ by (a) the bf16 forward, which
# runs as GEMMs of another shape under the vmap over clients and so moves
# gradients in their last bf16 bits; (b) top-k, which then flips entries
# near its threshold, each by at most a kept value; (c) the loop engine's
# value-form merge, which rounds g0 + y to the ulp of g0. With U a leaf's
# largest global update on the loop engine, an entry agrees when it is
# within 1e-2·U + 4 ulp(g0); at most 2% of a leaf's entries may disagree
# (top-k flips), and none by more than 2·U. Round losses: rel 1e-2.
ENGINE_AGREE_FRAC = 0.02
ENGINE_LOSS_RTOL = 1e-2
# Phase k: the async engine on phase 4's world. k(i), the degenerate
# configuration, trains each round as the loop engine does, step for step
# (both run engine.build_client_train_fn): the same arithmetic in the same
# order, so its clients' LoRA are held to phase 7's limit and its losses to
# rel 1e-6. Its merge sums the same client LoRA by tensordot, not by the
# host loop: each sum of k = 4 weighted terms (weights summing to 1) errs by
# at most 3 f32 ulp of the largest |term| either way, so the two merges of
# a round agree within MERGE_REASSOC_ULPS ulp of the clients' largest |x|
# at each entry. So that round 1 is held as exactly as round 0, the async
# run's round 1 pulls phase 4's round-0 global, put in place of its own
# merge 0 (which was checked first); its final global is then held to
# phase 6's limits. k(ii) is the JAX package's straggler run with every adaptive
# policy
# (tests/test_engine_equivalence.py::test_async_adaptive_policies_straggler_run),
# for ASYNC_MERGES merges (the JAX test's 6 cut to 4 for the script's time).
ROUND0_LORA_ATOL = 1e-6
MERGE_REASSOC_ULPS = 8
ASYNC_MERGES = 4
# Phase l. A restored sync run repeats the uninterrupted one's arithmetic on
# the same inputs in the same order, so it is held bit for bit. The async
# run is held as the JAX package's tests/test_service.py holds it: its
# accounting exactly, its global LoRA at ASYNC_RESUME_ATOL / _RTOL. The
# straggler run is snapshotted after merge ASYNC_SNAPSHOT_AFTER; the
# out-of-core run keeps OOC_HOT_SLOTS clients resident, below the cohort.
ASYNC_RESUME_ATOL, ASYNC_RESUME_RTOL = 5e-5, 1e-4
ASYNC_SNAPSHOT_AFTER = 2
OOC_HOT_SLOTS = 2
# Phase n: the launch layer's FibecFed train step (launch/steps.py, through
# launch/train.py's init_run and train_loop) at full qwen2-0.5b width: the GAL
# on the first 75% of the layers, local masks of ones, LAUNCH_GROUPS client
# groups of a LAUNCH_BATCH x LAUNCH_SEQ batch, LAUNCH_STEPS steps; B1 twice a
# step (the GAL tree and the local tree). It is held to the same steps with
# B1's plain version in its place: the same forward and backward, so the
# losses are held at rel LAUNCH_LOSS_RTOL and every state leaf at phase 7's
# ROUND0_LORA_ATOL; the frozen entries (GAL LoRA of the other layers, local
# LoRA of the GAL layers, their moments) bit for bit to the start. Then the
# prefill step (B8) over LAUNCH_PROMPTS prompts of LAUNCH_SEQ tokens and
# LAUNCH_DECODE decode steps, held to the teacher-forced training forward by
# phase 5d's SERVE_LOGIT_REL; then one train step profiled and counted.
LAUNCH_GROUPS, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_STEPS, LAUNCH_LR = 4, 16, 128, 4, 1e-4
LAUNCH_PROMPTS, LAUNCH_DECODE = 4, 8
LAUNCH_LOSS_RTOL = 1e-6
# Phase o: the launch layer's steps for the SSM, hybrid and encoder-decoder
# families. (i) Each at full width with no mesh, cut in depth (mamba2-1.3b
# to 4 layers, zamba2-7b to 6 Mamba2 layers: one application of its shared
# block, whisper-large-v3 to 4 + 4): LAUNCH_FAMILY_STEPS train steps of
# phase n's 4 client groups x 4 x 128 tokens held to the B1-plain twin as
# phase n holds its own, then a prefill of LAUNCH_PROMPTS x LAUNCH_SEQ and
# LAUNCH_FAMILY_DECODE greedy decode steps held to the teacher-forced
# training forward: mamba2 and zamba2 by phase f's oracle (the f32 forward,
# SSM_FLOOR_RATIO times the plain bf16 forward's own error), whisper by
# phase 5d's SERVE_LOGIT_REL. (ii) The same three at 2 layers each in f32
# (zamba2 with its shared block after every 2 layers, so that one
# application runs): the first layer of each kind run as the two
# ranks of a (1, 2) mesh run it, one after the other on this card (B9 over
# nh / 2 heads, B8 over half the heads), recombined as DTensor does and
# held to the whole layer: the heads' attention outputs and the conv
# windows bit for bit, the summed projections and the states (whose sums
# run in another order) within LAUNCH_HEADS_REL of their largest |value|.
LAUNCH_FAMILIES = {"mamba2-1.3b": dict(num_layers=4), "zamba2-7b": dict(num_layers=6),
                   "whisper-large-v3": dict(num_layers=4, encoder_layers=4)}
LAUNCH_TP_FAMILIES = {"mamba2-1.3b": dict(num_layers=2), "zamba2-7b": dict(num_layers=2, hybrid_period=2),
                      "whisper-large-v3": dict(num_layers=2, encoder_layers=2)}
LAUNCH_FAMILY_STEPS, LAUNCH_FAMILY_DECODE = 2, 4
LAUNCH_HEADS_REL = 1e-5
STRAGGLER_POLICIES = dict(buffer_size=2, merge_mode="delta", server_lr=0.8, staleness_cutoff=2, adapt_buffer=True,
                          adapt_steps=True, sampling_bias=2.0)


def engine_disagreement(g_loop, g_vec, g0):
    """(fraction of entries that disagree, max |diff| / U) of one leaf."""
    u = (g_loop - g0).abs().max()
    diff = (g_vec - g_loop).abs()
    bad = diff > 1e-2 * u + 4 * torch.finfo(torch.float32).eps * g0.abs()
    return bad.float().mean().item(), (diff.max() / u).item()


def difficulty_gap(loop_scores, vec_scores):
    """Per-batch difficulty of the two engines, client by client: the largest
    relative gap between them, the number of batch pairs whose order they
    swap, and the largest relative spread of a swapped pair's loop scores."""
    gap, swaps, spread = 0.0, 0, 0.0
    for dl, dv in zip(loop_scores, vec_scores):
        dl, dv = np.asarray(dl, np.float64), np.asarray(dv, np.float64)
        mag = np.maximum(np.abs(dl), 1e-30)
        gap = max(gap, float(np.max(np.abs(dv - dl) / mag)))
        swapped = np.sign(dl[:, None] - dl[None, :]) != np.sign(dv[:, None] - dv[None, :])
        swaps += int(np.sum(np.triu(swapped, 1)))
        if swapped.any():
            pair = np.abs(dl[:, None] - dl[None, :]) / np.maximum(mag[:, None], mag[None, :])
            spread = max(spread, float(pair[swapped].max()))
    return gap, swaps, spread


def log(*args):
    print(*args, flush=True)


def ptxas_summary(report):
    """One line per kernel from ``nvcc -Xptxas -v``: its registers, shared
    memory and spills (the report names the kernel, then its stack and
    spills, then its registers)."""
    lines, name, spill = [], "?", ""
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            lines.append(f"  {name}: {line.split(':', 1)[1].strip()}; {spill}")
    return lines


def cuda_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fn, other, rounds=5):
    """Medians of :func:`cuda_ms` of two calls timed in turns (fn, other,
    other, fn, ...), so that a drift of the host's speed reaches both."""
    a, b = [], []
    for r in range(rounds):
        for f, out in ((fn, a), (other, b)) if r % 2 == 0 else ((other, b), (fn, a)):
            out.append(cuda_ms(f))
    return float(np.median(a)), float(np.median(b))


def check_update(out, plain, old, frozen, what):
    """Frozen entries keep their bits; live ones agree with the plain version
    within 1e-6 relative (f32) or one ulp (bf16). Returns the max abs error."""
    if not torch.equal(out[frozen], old[frozen]):
        raise AssertionError(f"{what}: frozen entries changed")
    live = ~frozen
    if not bool(live.any()):
        return 0.0
    o, p = out[live].float(), plain[live].float()
    err = (o - p).abs()
    ulp = torch.finfo(out.dtype).eps if out.dtype == torch.bfloat16 else 1e-6
    bound = ulp * torch.maximum(p.abs(), torch.full_like(p, p.abs().max().item() * 1e-3))
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond tolerance")
    return err.max().item()


def check_equal(out, plain, what):
    """The same operations in the same order: bit for bit. Returns 0.0."""
    if out.dtype != plain.dtype or not torch.equal(out, plain):
        err = (out.float() - plain.float()).abs().max().item()
        raise AssertionError(f"{what}: differs from the plain version (max abs err {err})")
    return 0.0


def check_lora(out, plain, what):
    """A LoRA product against its plain version at the tolerance stated at
    ``LORA_TOL``. Returns the max abs error."""
    if out.dtype != plain.dtype or out.shape != plain.shape:
        raise AssertionError(f"{what}: {out.dtype} {tuple(out.shape)} vs {plain.dtype} {tuple(plain.shape)}")
    o, p = out.float(), plain.float()
    err = (o - p).abs()
    order = LORA_ORDER_REL * p.abs().max()
    if out.dtype == torch.float32:
        allowed = LORA_TOL + LORA_TOL * p.abs() + order
    else:
        _, e = torch.frexp(torch.maximum(o.abs(), p.abs()))
        allowed = torch.ldexp(torch.ones_like(o), e - 8) + order
    if not bool((err <= allowed).all()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond tolerance")
    return err.max().item()


def check_frozen_zero(y, frozen, what):
    if not bool((y[..., frozen] == 0).all()):
        raise AssertionError(f"{what}: a frozen column is not exactly 0")


def phase_kernels(ops, ref, gen):
    """Phase 3a: B1/B2 per client against their plain versions, moments in
    f32 and in bf16 (each returned in its own dtype), bit for bit; frozen
    entries keep their bits."""
    lr = 1e-3
    lr_t = torch.tensor(lr, dtype=torch.float32, device="cuda")
    for shape_name, shape in LEAF_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            p, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
            m32 = torch.randn(shape, generator=gen, device="cuda") * 0.1
            v32 = torch.rand(shape, generator=gen, device="cuda") * 0.1
            half = (torch.rand(shape, generator=gen, device="cuda") < 0.5).float()
            for mdtype in (torch.float32, torch.bfloat16):
                m, v = m32.to(mdtype), v32.to(mdtype)
                for mask in (None, half):
                    for active in (0.0, 1.0):
                        frozen = torch.zeros(shape, dtype=torch.bool, device="cuda") if mask is None else mask == 0
                        frozen = frozen | (active == 0.0)
                        what = f"{shape_name} {dtype} moments {mdtype} mask={mask is not None} active={active}"
                        # B1: AdamW
                        t = torch.tensor(4, dtype=torch.int32, device="cuda")
                        st = {"m": {"w": m}, "v": {"w": v}, "t": t}
                        mk = None if mask is None else {"w": mask}
                        new_p, new_st = ops.masked_adamw_update({"w": g}, st, {"w": p}, lr, mk, active)
                        t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
                        if not torch.equal(new_st["t"], t2):
                            raise AssertionError(f"adamw {what}: step counter {new_st['t']} != {t2}")
                        want = ref.masked_adamw_update_ref(p, g, m, v, mask, lr_t, mhat, vhat, active=active)
                        for out, plain, old, n in zip((new_p["w"], new_st["m"]["w"], new_st["v"]["w"]), want,
                                                      (p, m, v), "pmv"):
                            check_equal(out, plain, f"adamw {n} {what}")
                            check_equal(out[frozen], old[frozen], f"adamw frozen {n} {what}")
                        # B2: SGD, with and without momentum
                        for momentum in (0.0, 0.9):
                            st = {"mu": {"w": m}} if momentum else {}
                            new_p, new_st = ops.masked_sgd_update({"w": g}, st, {"w": p}, lr, mk, active,
                                                                  momentum=momentum)
                            pp, pmu = ref.masked_sgd_update_ref(p, g, m if momentum else None, mask, lr_t,
                                                                momentum=momentum, active=active)
                            check_equal(new_p["w"], pp, f"sgd({momentum}) p {what}")
                            if momentum:
                                check_equal(new_st["mu"]["w"], pmu, f"sgd mu {what}")
    torch.cuda.synchronize()
    log("B1/B2 vs plain: all leaf shapes, params f32/bf16, moments f32/bf16, mask on/off, active 0/1, "
        "momentum 0/0.9: bit for bit (B1's bias scales computed in the kernel from t)")
    return {"masked_adamw_update": 0.0, "masked_sgd_update": 0.0}


def phase_stacked_kernels(ops, ref, gen):
    """Phase 3b: B1/B2 over K stacked clients, one row of scalars each (mixed
    active, different Adam step counts), against their plain versions."""
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    t = torch.tensor([0, 3, 7, 1], dtype=torch.int32, device="cuda")
    lr_t = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    for shape_name, shape in LEAF_SHAPES.items():
        for dtype, mdtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                              (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)):
            s = (K,) + shape
            p, g = (torch.randn(s, generator=gen, device="cuda").to(dtype) for _ in range(2))
            m = (torch.randn(s, generator=gen, device="cuda") * 0.1).to(mdtype)
            v = (torch.rand(s, generator=gen, device="cuda") * 0.1).to(mdtype)
            mask = (torch.rand(s, generator=gen, device="cuda") < 0.5).float()
            rows = lambda x: x.reshape((K,) + (1,) * len(shape))  # noqa: E731
            what = f"stacked {shape_name} {dtype} moments {mdtype}"
            new_p, st = ops.masked_adamw_update({"w": g}, {"m": {"w": m}, "v": {"w": v}, "t": t},
                                                {"w": p}, lr_t, {"w": mask}, active)
            t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
            if st["t"].tolist() != [1, 3, 8, 2] or not torch.equal(st["t"], t2):
                raise AssertionError(f"{what}: Adam step counters {st['t'].tolist()}")
            want = ref.masked_adamw_update_ref(p, g, m, v, mask, lr_t, rows(mhat), rows(vhat), active=rows(active))
            for out, w, n in zip((new_p["w"], st["m"]["w"], st["v"]["w"]), want, "pmv"):
                check_equal(out, w, f"adamw {n} {what}")
            check_equal(new_p["w"][1], p[1], f"adamw inactive client {what}")
            for momentum in (0.0, 0.9):
                new_p, st = ops.masked_sgd_update({"w": g}, {"mu": {"w": m}} if momentum else {}, {"w": p},
                                                  lr_t, {"w": mask}, active, momentum=momentum)
                wp, wmu = ref.masked_sgd_update_ref(p, g, m if momentum else None, mask, lr_t,
                                                    momentum=momentum, active=rows(active))
                check_equal(new_p["w"], wp, f"sgd({momentum}) p {what}")
                if momentum:
                    check_equal(st["mu"]["w"], wmu, f"sgd mu {what}")
    torch.cuda.synchronize()
    log(f"B1/B2 stacked over {K} clients vs plain: all leaf shapes, params and moments f32/bf16, mixed "
        "active, per-client step counters, momentum 0/0.9: bit for bit")
    return {"masked_adamw_update_stacked": 0.0, "masked_sgd_update_stacked": 0.0}


def phase_sgd_trees(ops, ref, gen, tree_leaves, tree_map):
    """Phase 3b': B2 over whole trees, as the engines call it: one client's
    LoRA tree (the ``a`` leaves dense, the ``b`` leaves masked: a mask tree
    holding None), the same tree with half its leaves bf16, and K stacked
    clients' trees with a per-client ``active`` that holds zeros; lr as a
    Python number and as a 0-d tensor, momentum 0 and 0.9. One launch per
    tree, every leaf bit for bit equal to its plain version."""
    randn = lambda s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    n_trees = 0
    for lead, active in (((), None), ((K,), torch.tensor([1.0, 0.0, 1.0, 0.0], device="cuda"))):
        for mixed in (False, True):
            params, grads, mus = lora_tree(randn, lead), lora_tree(randn, lead), lora_tree(randn, lead)
            if mixed:
                params = {"layers": {t: {"a": ab["a"].bfloat16(), "b": ab["b"]} for t, ab in params["layers"].items()}}
                grads = tree_map(lambda p, g: g.to(p.dtype), params, grads)
            mask = {"layers": {t: {"a": None, "b": (torch.rand(ab["b"].shape, generator=gen, device="cuda") < 0.5)
                                   .float()} for t, ab in params["layers"].items()}}
            for lr in (1e-3, torch.tensor(1e-3, device="cuda")):
                lr_t = lr if isinstance(lr, torch.Tensor) else ops.as_f32(lr, "cuda")
                for momentum in (0.0, 0.9):
                    before = ops.masked_sgd_update.launches
                    new_p, st = ops.masked_sgd_update(grads, {"mu": mus} if momentum else {}, params, lr, mask,
                                                      active, momentum=momentum)
                    if ops.masked_sgd_update.launches != before + 1:
                        raise AssertionError("B2 took more than one launch for a LoRA tree")
                    what = f"sgd tree lead={lead} mixed={mixed} lr={type(lr).__name__} momentum={momentum}"
                    for p, g, mu, mk, o, omu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(mus),
                                                    tree_leaves(mask), tree_leaves(new_p),
                                                    tree_leaves(st["mu"]) if momentum else tree_leaves(mus)):
                        wp, wmu = ref.masked_sgd_update_ref(p, g, mu if momentum else None, mk, lr_t,
                                                            momentum=momentum, active=ops.per_client(active, p))
                        check_equal(o, wp, f"{what} p")
                        if momentum:
                            check_equal(omu, wmu, f"{what} mu")
                    n_trees += 1
    torch.cuda.synchronize()
    log(f"B2 over whole LoRA trees: {n_trees} trees (one client and {K} stacked with a zero in active; f32 and "
        "half bf16; dense a, masked b; lr number/tensor; momentum 0/0.9): one launch each, bit for bit")


def phase_adamw_trees(ops, ref, gen, tree_leaves, tree_map):
    """Phase 3b'': B1 over whole trees, as the engines call it: one client's
    LoRA tree (``a`` dense, ``b`` masked: a mask tree holding None), the same
    tree with half its leaves and their moments bf16, and K stacked clients'
    trees with per-client step counters and an ``active`` read in place from
    a column of a step plan (a strided view that holds zeros); lr as a
    Python number and as a 0-d tensor. One launch per tree; every leaf, its
    moments and the step counters bit for bit equal to the plain version."""
    randn = lambda s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    plan = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 0.0]], device="cuda")
    n_trees = 0
    for lead, active, t in (((), None, torch.tensor(6, dtype=torch.int32, device="cuda")),
                            ((K,), plan[:, 0], torch.tensor([0, 3, 7, 1], dtype=torch.int32, device="cuda"))):
        for mixed in (False, True):
            params, grads = lora_tree(randn, lead), lora_tree(randn, lead)
            m, v = lora_tree(lambda s: randn(s) * 0.1, lead), lora_tree(lambda s: randn(s).abs() * 0.1, lead)
            if mixed:
                low = lambda tree: {"layers": {n: {"a": ab["a"].bfloat16(), "b": ab["b"]}  # noqa: E731
                                               for n, ab in tree["layers"].items()}}
                params, grads, m, v = low(params), low(grads), low(m), low(v)
            mask = {"layers": {n: {"a": None, "b": (torch.rand(ab["b"].shape, generator=gen, device="cuda") < 0.5)
                                   .float()} for n, ab in params["layers"].items()}}
            st = {"m": m, "v": v, "t": t}
            for lr in (1e-3, torch.tensor(1e-3, device="cuda")):
                lr_t = lr if isinstance(lr, torch.Tensor) else ops.as_f32(lr, "cuda")
                before = ops.masked_adamw_update.launches
                new_p, new_st = ops.masked_adamw_update(grads, st, params, lr, mask, active, wd=0.01)
                if ops.masked_adamw_update.launches != before + 1:
                    raise AssertionError("B1 took more than one launch for a LoRA tree")
                what = f"adamw tree lead={lead} mixed={mixed} lr={type(lr).__name__}"
                t2, mhat, vhat = ops.adam_step_scales(t, active, 0.9, 0.999)
                check_equal(new_st["t"], t2, f"{what} t")
                rows = ops.per_client
                for leaves in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(m), tree_leaves(v),
                                  tree_leaves(mask), tree_leaves(new_p), tree_leaves(new_st["m"]),
                                  tree_leaves(new_st["v"])):
                    p, g, mm, vv, mk = leaves[:5]
                    want = ref.masked_adamw_update_ref(p, g, mm, vv, mk, lr_t, rows(mhat, p), rows(vhat, p),
                                                       wd=0.01, active=rows(active, p))
                    for out, w, name in zip(leaves[5:], want, "pmv"):
                        check_equal(out, w, f"{what} {name} {tuple(p.shape)}")
                n_trees += 1
    torch.cuda.synchronize()
    log(f"B1 over whole LoRA trees: {n_trees} trees (one client and {K} stacked with a zero in active; f32 and "
        "half bf16 with bf16 moments; dense a, masked b; lr number/tensor): one launch each, bit for bit")


def plain_fake_compress(ops, ref, tree_map, delta, residual, mask, *, qmax, topk_ratio, use_thresh,
                        stacked=False):
    """``ops.fake_compress`` step by step with the plain version: each leaf's
    threshold from a sort (``ops.compress_rows``), then the round trip."""

    def one(d, r, mk):
        x2, thresh, scale = ops.compress_rows(d, r, mk, qmax=qmax, topk_ratio=topk_ratio,
                                              use_thresh=use_thresh, stacked=stacked)
        y, res = ref.fake_compress_ref(x2, thresh, scale, qmax=qmax, use_thresh=use_thresh,
                                       per_leaf_scale=use_thresh and qmax > 0)
        return y.reshape(d.shape), res.reshape(d.shape)

    none = tree_map(lambda _: None, delta)
    return tree_map(one, delta, none if residual is None else residual, none if mask is None else mask)


COMPRESS_MODES = {"int8": (127, 1.0, False), "int4": (7, 1.0, False), "topk/int8": (127, 0.1, True),
                  "topk/float": (0, 0.1, True)}


def compress_case(gen, shapes, dtype, stacked, mask_kind):
    """Deltas and residuals of ``shapes`` (the first leaf: a few distinct
    values, so ties sit at every threshold, and, stacked, an all-zero first
    row) and the count mask: GAL (L, 1, 1), one shared of a client's leaf
    shape, or per client of the leaf's full shape."""
    d = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-2).to(dtype) for k, s in shapes.items()}
    r = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3).to(dtype) for k, s in shapes.items()}
    first = next(iter(shapes))
    d[first] = (torch.round(d[first].float() * 300) / 300).to(dtype)
    r[first].zero_()
    if stacked:
        d[first][0] = 0.0
    client = (lambda s: s[1:]) if stacked else (lambda s: s)
    masks = {
        "gal": lambda s: (torch.rand((client(s)[0], 1, 1), generator=gen, device="cuda") < 0.75).float(),
        "shared": lambda s: (torch.rand(client(s), generator=gen, device="cuda") < 0.5).float(),
        "per_client": lambda s: (torch.rand(s, generator=gen, device="cuda") < 0.5).float(),
    }
    return d, r, {k: masks[mask_kind](s) for k, s in shapes.items()}


def phase_compress_kernel(ops, ref, gen, tree_map):
    """Phase 3c: B3 over whole trees against its plain version: the LoRA
    leaves plus a leaf whose rows are no multiple of the 128-value group (or
    of 4 values), one client and K stacked; f32 and bf16; int8, int4,
    top-k/int8 and top-k/float; with and without a residual; a GAL, a shared
    and a per-client mask; then rows longer than the kernel's shared memory.
    One launch per tree, bit for bit."""
    n_checked = 0
    both = (torch.float32, torch.bfloat16)
    cases = []  # (shapes, stacked, mask kind, dtypes, modes)
    for stacked in (False, True):
        lead = (K,) if stacked else ()
        shapes = {f"{t}_{ab}": lead + LEAF_SHAPES[s] for t, (sa, sb) in
                  {"wq": ("a", "b_q_o"), "wk": ("a", "b_k_v"), "wv": ("a", "b_k_v"), "wo": ("a", "b_q_o")}.items()
                  for ab, s in (("a", sa), ("b", sb))}
        shapes["z_ragged"] = lead + (24, 7, 131)
        for kind in ("gal", "shared", "per_client") if stacked else ("gal", "shared"):
            cases.append((shapes, stacked, kind, both, list(COMPRESS_MODES)))
    # top-k rows longer than a cluster's shared memory holds (196,608 f32 or
    # 393,216 bf16 values), beside a row that fits
    for dtype, row in ((torch.float32, 200_000), (torch.bfloat16, 400_000)):
        cases.append(({"a_long": (2, 8, row // 8), "b_fits": (2, 8, 1000)}, True, "per_client", (dtype,),
                      ["topk/int8", "topk/float"]))
    for shapes, stacked, kind, dtypes, modes in cases:
        for dtype in dtypes:
            d, r, mk = compress_case(gen, shapes, dtype, stacked, kind)
            for mode in modes:
                qmax, ratio, use_thresh = COMPRESS_MODES[mode]
                for res in (None, r):
                    kw = dict(qmax=qmax, topk_ratio=ratio, use_thresh=use_thresh, stacked=stacked)
                    before = ops.fake_compress.launches
                    y, rr = ops.fake_compress(d, res, mk, **kw)
                    if ops.fake_compress.launches != before + 1:
                        raise AssertionError("B3 took more than one launch for a tree")
                    want = plain_fake_compress(ops, ref, tree_map, d, res, mk, **kw)
                    for key in d:
                        what = f"{tuple(d[key].shape)} {dtype} {mode} residual={res is not None} mask={kind}"
                        check_equal(y[key], want[key][0], f"fake_compress y {what}")
                        check_equal(rr[key], want[key][1], f"fake_compress residual {what}")
                    n_checked += 1
    torch.cuda.synchronize()
    log(f"B3 vs plain: {n_checked} trees (8 LoRA leaves and a ragged one, one client and {K} stacked; "
        "f32/bf16; int8, int4, top-k int8/float; residual on/off; GAL, shared and per-client masks; ties, "
        "an all-zero row; rows beyond the cluster's shared memory): one launch each, bit for bit")
    return {"fake_compress": 0.0}


def lora_tree(kind, lead=()):
    """A full-width qwen2-0.5b LoRA-shaped tree, with optional leading axes."""
    shapes = {"wq": ("a", "b_q_o"), "wk": ("a", "b_k_v"), "wv": ("a", "b_k_v"), "wo": ("a", "b_q_o")}
    return {"layers": {t: {"a": kind(lead + LEAF_SHAPES[sa]), "b": kind(lead + LEAF_SHAPES[sb])}
                       for t, (sa, sb) in shapes.items()}}


def bound_of(bytes_moved, flops, flops_per_s=F32_FLOPS_PER_S):
    """The least time for a call that moves ``bytes_moved`` (each input read
    once, each output written once) and does ``flops`` operations at
    ``flops_per_s`` (f32 outside the tensor cores unless given)."""
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    flops_s = flops / flops_per_s
    return dict(bound_ms=max(bytes_s, flops_s) * 1e3, bound_by="bytes" if bytes_s >= flops_s else "operations")


def bound(name, n_elems):
    spec = KERNELS[name]
    return bound_of(n_elems * spec["bytes_per_elem"], n_elems * spec["flops_per_elem"])


def phase_timing(ops, ref, gen, tree_leaves, tree_map):
    """Kernel, plain-version and library times in the main paths'
    configurations: one optimizer step over the whole LoRA tree per client
    (loop engine) and over K stacked clients (vectorized engine), and one
    compressed upload of K stacked clients' trees and of one client's. ``ms``
    is the wrapper (host work and launch), ``graph_ms`` the device time from
    a CUDA graph of calls over inputs that together exceed the 50 MB L2."""
    randn = lambda s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    lr = 4e-4
    lr_t = torch.tensor(lr, dtype=torch.float32, device="cuda")
    times = {}

    def rotation(bytes_per_call, make):
        copies = math.ceil(2 * L2_BYTES / bytes_per_call)
        return copies, [make() for _ in range(copies)]

    for lead, suffix in (((), ""), ((K,), "_stacked")):
        params, grads = lora_tree(randn, lead), lora_tree(randn, lead)
        n = sum(x.numel() for x in tree_leaves(params))
        # B1 as fibecfed runs it: f32, every leaf masked (a: ones, b: neuron
        # mask), lr a Python number; stacked, active a column of the step plan
        neuron = lambda: lora_tree(lambda s: (torch.rand(s, generator=gen, device="cuda") < 0.5).float(), lead)  # noqa: E731
        mask = neuron()
        for ab in mask["layers"].values():
            ab["a"].fill_(1.0)
        t0 = torch.full(lead, 3, dtype=torch.int32, device="cuda")
        active = torch.ones((K, 2), device="cuda")[:, 0] if lead else None
        adam_state = lambda g: {"m": tree_map(lambda x: x * 0.01, g), "v": tree_map(lambda x: x * x * 1e-3, g),  # noqa: E731
                                "t": t0}
        st = adam_state(grads)
        rows = ops.per_client

        def plain_adamw():
            _, mhat, vhat = ops.adam_step_scales(st["t"], active, 0.9, 0.999)
            return tree_map(lambda p, g, m, v, mk: ref.masked_adamw_update_ref(
                p, g, m, v, mk, lr_t, rows(mhat, p), rows(vhat, p), active=rows(active, p)),
                params, grads, st["m"], st["v"], mask)

        # B2: dense per client (fedavg_lora), rank-masked when stacked
        sgd_mask = mask if lead else None

        def plain_sgd():
            return tree_map(lambda p, g, mk: ref.masked_sgd_update_ref(p, g, None, mk, lr_t, active=rows(active, p)),
                            params, grads, sgd_mask if sgd_mask is not None else tree_map(lambda _: None, params))

        p_list, g_list, mk_list = tree_leaves(params), tree_leaves(grads), tree_leaves(mask)
        # the nearest single call: PyTorch's fused AdamW over the same tree,
        # unmasked and without per-client steps (not the same function)
        fused = [[x.clone() for x in tree_leaves(t)] for t in (params, st["m"], st["v"])]
        steps = [torch.tensor(4.0, device="cuda") for _ in p_list]
        nearest = lambda: torch._fused_adamw_(fused[0], g_list, fused[1], fused[2], [], steps, lr=lr,  # noqa: E731
                                              beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                                              amsgrad=False, maximize=False)
        b1_step = lambda: ops.masked_adamw_update(grads, st, params, lr, mask, active)  # noqa: E731
        copies, rot = rotation(KERNELS["masked_adamw_update" + suffix]["bytes_per_elem"] * n,
                               lambda: (lora_tree(randn, lead), lora_tree(randn, lead), neuron()))
        rot_st = [adam_state(g) for _, g, _ in rot]
        times["masked_adamw_update" + suffix] = dict(
            ms=cuda_ms(b1_step), plain_ms=cuda_ms(plain_adamw),
            graph_ms=graph_ms(lambda i: ops.masked_adamw_update(rot[i % copies][1], rot_st[i % copies],
                                                                rot[i % copies][0], lr, rot[i % copies][2],
                                                                active), calls=4 * copies),
            # no single PyTorch call computes a masked AdamW step
            library_ms=None, nearest_ms=cuda_ms(nearest), **bound("masked_adamw_update" + suffix, n),
        )
        del rot, rot_st, fused
        # B2: lr a Python number, as both engines pass it (by value, no device
        # work); one foreach call computes p - lr·g unmasked, p - lr·g·mask
        # with the stacked path's binary mask (every client active)
        copies, rot = rotation(KERNELS["masked_sgd_update" + suffix]["bytes_per_elem"] * n,
                               lambda: (lora_tree(randn, lead), lora_tree(randn, lead), neuron() if lead else None))
        b2_step = lambda: ops.masked_sgd_update(grads, {}, params, lr, sgd_mask, active)  # noqa: E731
        lib_step = ((lambda: torch._foreach_addcmul(p_list, g_list, mk_list, value=-lr)) if lead
                    else (lambda: torch._foreach_add(p_list, g_list, alpha=-lr)))
        times["masked_sgd_update" + suffix] = dict(
            ms=cuda_ms(b2_step), plain_ms=cuda_ms(plain_sgd), library_ms=cuda_ms(lib_step),
            graph_ms=graph_ms(lambda i: ops.masked_sgd_update(rot[i % copies][1], {}, rot[i % copies][0], lr,
                                                              rot[i % copies][2], active), calls=4 * copies),
            **bound("masked_sgd_update" + suffix, n),
        )
        # both are host-bound: also timed in turns, so that a drift of the
        # host's speed reaches both (medians of 5; beside ms, not instead)
        entry = times["masked_sgd_update" + suffix]
        entry["paired_ms"], entry["paired_library_ms"] = paired_ms(b2_step, lib_step)
        del rot
        log(f"one optimizer step over {'%d stacked' % lead[0] if lead else 'one'} LoRA tree(s) "
            f"({n} elements, 8 leaves)")

    # B3 as the vectorized compressed round calls it: K stacked clients'
    # GAL deltas, their residuals and their per-client count masks; and one
    # client's upload as the loop engine calls it, with the GAL mask
    upload = lambda: (lora_tree(lambda s: randn(s) * 1e-3, (K,)), lora_tree(lambda s: randn(s) * 1e-4, (K,)),  # noqa: E731
                      lora_tree(lambda s: (torch.rand(s, generator=gen, device="cuda") < 0.75).float(), (K,)))
    delta, res, cmask = upload()
    n = sum(x.numel() for x in tree_leaves(delta))
    kw = dict(qmax=127, topk_ratio=0.1, use_thresh=True)
    copies, rot = rotation(KERNELS["fake_compress"]["bytes_per_elem"] * n, upload)
    one = lambda tree, i=0: tree_map(lambda x: x[i], tree)  # noqa: E731
    gal = tree_map(lambda x: torch.ones((x.shape[1], 1, 1), device="cuda"), delta)
    delta1, res1 = one(delta), one(res)
    n_one = n // K
    times["fake_compress"] = dict(
        ms=cuda_ms(lambda: ops.fake_compress(delta, res, cmask, stacked=True, **kw)),
        plain_ms=cuda_ms(lambda: plain_fake_compress(ops, ref, tree_map, delta, res, cmask, stacked=True, **kw)),
        graph_ms=graph_ms(lambda i: ops.fake_compress(*rot[i % copies], stacked=True, **kw), calls=4 * copies),
        ms_one_client=cuda_ms(lambda: ops.fake_compress(delta1, res1, gal, **kw)),
        graph_ms_one_client=graph_ms(lambda i: ops.fake_compress(one(rot[i % copies][0], i % K),
                                                                 one(rot[i % copies][1], i % K), gal, **kw),
                                     calls=4 * K * copies),
        # a GAL (L, 1, 1) mask is 16 B/value: d and r read, y and r written
        bound_ms_one_client=bound_of(16 * n_one, KERNELS["fake_compress"]["flops_per_elem"] * n_one)["bound_ms"],
        # no single PyTorch call thresholds, fake-quantizes and keeps the
        # residual (torch.fake_quantize_per_tensor_affine does the middle step)
        library_ms=None, **bound("fake_compress", n),
    )
    del rot
    log(f"one compressed upload of {K} stacked clients ({n} elements, 8 leaves) and of one client")
    log("kernel times:", json.dumps(times))
    return times


def client_lora(client, target, layer):
    """One client's LoRA ``a`` (K, r), ``b`` (r, N) and neuron keep-mask (N,)
    of one target at one layer."""
    ab = client.lora["layers"][target]
    return ab["a"][layer], ab["b"][layer], client.neuron_mask["layers"][target]["b"][layer, 0, :]


def adapter_stack(clients, target, layer):
    """The clients' adapters of one target at one layer, stacked: a (A, K, r),
    b (A, r, N), mask (A, N)."""
    parts = [client_lora(c, target, layer) for c in clients]
    return tuple(torch.stack(xs).contiguous() for xs in zip(*parts))


def drive_lora(ops, ref, x, a, b, keep, scale, what):
    """B5 and B6 on one input against their plain versions; masked columns
    exactly 0. Returns the max abs errors."""
    y = ops.sparse_lora_apply(x, a, b, keep, scale)
    e5 = check_lora(y, ref.sparse_lora_matmul_ref(x, a, b, keep, scale), f"B5 {what}")
    check_frozen_zero(y, keep == 0, f"B5 {what}")
    yp = ops.sparse_lora_apply_packed(x, a, b, keep, scale)
    e6 = check_lora(yp, ref.sparse_lora_apply_packed_ref(x, a, b, keep, scale), f"B6 {what}")
    check_lora(yp, y, f"B6 vs B5 {what}")
    kept = keep != 0
    check_equal(yp[:, kept], y[:, kept], f"B6 vs B5 kept columns {what}")  # b · 1 is b
    check_frozen_zero(yp, keep == 0, f"B6 {what}")
    return e5, e6


def skewed_rows(gen, M, A, lead=()):
    """Adapter indices with 3/4 of the rows on adapter 0 and the rest spread
    evenly over the others (multi-tenant serving's heavy tenant)."""
    idx = torch.randint(1, A, lead + (M,), generator=gen, device="cuda")
    return torch.where(torch.rand(lead + (M,), generator=gen, device="cuda") < 0.75, 0, idx)


def drive_batched(ops, ref, x, idx, a, b, mask, scale, what):
    """B7 against its plain version; a row whose index lies outside [0, A)
    is exactly 0, and so is every row's own frozen column. Returns y, the
    max abs error and the name of the path's counter that the call moved."""
    fn = ops.batched_sparse_lora_apply
    before = {name: getattr(fn, COUNTERS[name][1]) for name in B7_KERNELS}
    y = fn(x, idx, a, b, mask, scale)
    (path,) = [name for name in B7_KERNELS if getattr(fn, COUNTERS[name][1]) != before[name]]
    K, N = x.shape[-1], b.shape[-1]
    err = check_lora(y.reshape(-1, N), ref.batched_sparse_lora_matmul_ref(
        x.reshape(-1, K), idx.reshape(-1), a, b, mask, scale), f"B7 {what}")
    out = (idx < 0) | (idx >= a.shape[0])
    if not bool((y[out] == 0).all()):
        raise AssertionError(f"B7 {what}: a row with an out-of-range adapter is not 0")
    frozen = mask[idx.clamp(0, a.shape[0] - 1)] == 0
    if not bool((y[frozen & ~out[..., None]] == 0).all()):
        raise AssertionError(f"B7 {what}: a frozen column is not exactly 0")
    return y, err, path


def phase_ops(ops, ref, sparse_lora, vec, cfg, gen, tree_leaves, tree_map):
    """Phase 5b: the four public wrappers of ``repro_torch.kernels.ops`` on
    the vectorized run's own FIM trees, LoRA and neuron masks (the FIM
    warmup's rho = 0.5 masks), then at shapes off any tile grid. Returns the
    launch counts of the run and the max abs errors."""
    clients = vec.clients
    c0 = clients[0]
    scale = cfg.lora_alpha / cfg.lora_rank
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    errs = dict.fromkeys(("fisher_diag_update", "sparse_lora_apply", "sparse_lora_apply_packed", *B7_KERNELS), 0.0)

    def note(name, err):
        errs[name] = max(errs[name], err)

    n_lora = 0
    with Launches(ops) as run:
        # B4: one client's FIM tree, then all clients' stacked; g f32 and bf16
        stacked_fim = tree_map(lambda *xs: torch.stack(xs), *[c.fim for c in clients])
        for fim in (c0.fim, stacked_fim):
            g = tree_map(lambda f: randn(*f.shape) * 1e-3, fim)
            for gg in (g, tree_map(lambda t: t.bfloat16(), g)):
                out = ops.fisher_diag_update(fim, gg, 0.9)
                plain = tree_map(lambda f, t: ref.fisher_diag_update_ref(t, f, 0.9), fim, gg)
                for o, w in zip(tree_leaves(out), tree_leaves(plain)):
                    check_equal(o, w, f"B4 {tuple(o.shape)} g {gg['layers']['wq']['a'].dtype}")
        n_fim = sum(x.numel() for x in tree_leaves(stacked_fim))
        # B5/B6: each target at a few layers, one client's real LoRA and masks
        for target in ("wq", "wk", "wv", "wo"):
            for layer in OPS_LAYERS:
                a, b, keep = client_lora(c0, target, layer)
                for rows in OPS_ROWS:
                    x = randn(rows, a.shape[0]).bfloat16()
                    e5, e6 = drive_lora(ops, ref, x, a, b, keep, scale, f"{target}[{layer}] M={rows} bf16")
                    note("sparse_lora_apply", e5)
                    note("sparse_lora_apply_packed", e6)
                    n_lora += 1
        a, b, keep = client_lora(c0, "wq", OPS_LAYERS[1])
        x = randn(4, 64, a.shape[0])  # f32, with leading dims (B, S, K)
        x2 = x.reshape(-1, x.shape[-1])
        e5, e6 = drive_lora(ops, ref, x2, a, b, keep, scale, "wq f32")
        note("sparse_lora_apply", e5)
        note("sparse_lora_apply_packed", e6)
        y3 = ops.sparse_lora_apply(x, a, b, keep, scale)
        check_equal(y3.reshape(x2.shape[0], -1), ops.sparse_lora_apply(x2, a, b, keep, scale), "B5 leading dims")
        # B7: the 8 clients' wq adapters at one layer, rows spread at random
        a8, b8, m8 = adapter_stack(clients, "wq", OPS_LAYERS[1])
        n_ad = a8.shape[0]
        x = randn(16, OPS_ROWS[0], a8.shape[1]).bfloat16()  # (B, S, K)
        idx = torch.randint(0, n_ad, (16, OPS_ROWS[0]), generator=gen, device="cuda")
        idx[:, ::97] = n_ad
        idx[:, 5::101] = -1
        for xx in (x, x.float()):
            _, e7, path = drive_batched(ops, ref, xx, idx, a8, b8, m8, scale, f"A={n_ad} (B, S, K) {xx.dtype}")
            note(path, e7)
        # the batch skewed to one adapter, adapters 1 and 3 owning no row,
        # every row out of range (-1 and A), and every row on adapter 0,
        # which is B5's product bit for bit (the same per-tile code)
        ragged = {"skewed": skewed_rows(gen, OPS_ROWS[0], n_ad, (16,)),
                  "no rows on 1, 3": torch.where((idx == 1) | (idx == 3), 2, idx),
                  "all out of range": torch.where(idx % 2 == 0, -1, n_ad + idx.abs())}
        for kind, ix in ragged.items():
            _, e7, path = drive_batched(ops, ref, x, ix, a8, b8, m8, scale, f"A={n_ad} {kind}")
            note(path, e7)
        y0, e7, path = drive_batched(ops, ref, x, torch.zeros_like(idx), a8, b8, m8, scale, f"A={n_ad} all on 0")
        note(path, e7)
        check_equal(y0, ops.sparse_lora_apply(x, a8[0], b8[0], m8[0], scale), "B7 all rows on adapter 0 vs B5")
        # one adapter: the unbatched product
        y1, e7, path = drive_batched(ops, ref, x, torch.zeros_like(idx), a8[:1], b8[:1], m8[:1], scale, "A=1")
        note(path, e7)
        check_equal(y1, ops.sparse_lora_apply(x, a8[0], b8[0], m8[0], scale), "B7 A=1 vs B5")
        # the card's plan (rows sorted by adapter, segment offsets) against its plain twin
        x2, ix2 = x.reshape(-1, x.shape[-1]), idx.reshape(-1).int()
        plan = torch.full((x2.shape[0] + n_ad + 2,), -1, dtype=torch.int32, device="cuda")
        sparse_lora.sparse_lora_launch(torch.empty(x2.shape[0], b8.shape[2], dtype=x2.dtype, device="cuda"), x2,
                                       a8, b8, m8, ix2, scale=scale, plan=plan)
        check_equal(plan, sparse_lora.sgmv_plan(ix2, n_ad), "B7 plan vs its twin")
        sgmv = {f"A={A} M={M} r={r}": sparse_lora.resident_stages(a8.shape[1], b8.shape[2], r, torch.bfloat16,
                                                                    adapters=A, rows=M)
                for A, M, r in ((n_ad, x2.shape[0], cfg.lora_rank), (64, 4096, cfg.lora_rank),
                                (64, 1000, cfg.lora_rank), (n_ad, x2.shape[0], 64))}
        # 64 random wq-shaped adapters: on the SGMV path at 4096 rows, on the
        # split path at 1000 (fewer than 16 rows an adapter) and at rank 64
        K8, N8 = a8.shape[1], b8.shape[2]
        for M, r in ((4096, cfg.lora_rank), (1000, cfg.lora_rank), (1000, 64)):
            a64, b64 = randn(64, K8, r) * 0.05, randn(64, r, N8) * 0.05
            m64 = (torch.rand(64, N8, generator=gen, device="cuda") < 0.5).float()
            x64 = randn(M, K8).bfloat16()
            for kind, ix in (("random", torch.randint(0, 64, (M,), generator=gen, device="cuda")),
                             ("skewed", skewed_rows(gen, M, 64))):
                _, e7, path = drive_batched(ops, ref, x64, ix, a64, b64, m64, scale, f"A=64 M={M} r={r} {kind}")
                note(path, e7)
        # B7's few-row path on the clients' adapters of every target: a decode
        # step's rows, one a client; one row; rows sharing adapters with
        # indices out of range; up to its 64 rows
        few = {}
        for target in ("wq", "wk", "wv", "wo"):
            aT, bT, mT = adapter_stack(clients, target, OPS_LAYERS[1])
            KT, NT = aT.shape[1], bT.shape[2]
            for M in FEW_ROWS:
                ix = torch.arange(M, device="cuda") % n_ad
                if M > SERVE_SLOTS:
                    ix = torch.randint(-1, n_ad + 1, (M,), generator=gen, device="cuda")
                few[f"{target} M={M}"] = sparse_lora.batched_path(M, KT, NT, cfg.lora_rank, torch.bfloat16, n_ad)
                for dtype in (torch.bfloat16, torch.float32):
                    _, e, path = drive_batched(ops, ref, randn(M, KT).to(dtype), ix, aT, bT, mT, scale,
                                               f"few rows {target} M={M} {dtype}")
                    note(path, e)
        # off any tile grid: ragged M, K and N; ranks whose rows fill no
        # 16-byte load (6) or no power of two (12); random weights
        M, K, N = 200, 300, 250
        for r in (4, 16, 6, 12):
            for dtype in (torch.float32, torch.bfloat16):
                x, a, b = randn(M, K).to(dtype), randn(K, r), randn(r, N)
                keep = (torch.rand(N, generator=gen, device="cuda") < 0.5).float()
                what = f"M={M} K={K} N={N} r={r} {dtype}"
                e5, e6 = drive_lora(ops, ref, x, a, b, keep, 0.5, what)
                note("sparse_lora_apply", e5)
                note("sparse_lora_apply_packed", e6)
                idx = torch.randint(-1, 4, (M,), generator=gen, device="cuda")
                masks = (torch.rand(3, N, generator=gen, device="cuda") < 0.5).float()
                _, e7, path = drive_batched(ops, ref, x, idx, randn(3, K, r), randn(3, r, N), masks, 0.5, what)
                note(path, e7)
        # the single-adapter kernels by rank (1, 8 and 16 keep a and b ⊙ mask
        # in shared memory here, 64 reads them from L2), rows past the last
        # whole tile, K with no 16-byte rows, all-zero, all-one and rho 0.5 masks
        M, K = 1000, 301
        paths = {}
        for r in LORA_RANKS:
            for N in LORA_WIDTHS:
                for kind in ("zero", "one", "half"):
                    for dtype in (torch.float32, torch.bfloat16):
                        x, a, b = randn(M, K).to(dtype), randn(K, r), randn(r, N)
                        keep = (torch.rand(N, generator=gen, device="cuda") < LORA_MASKS[kind]).float()
                        e5, e6 = drive_lora(ops, ref, x, a, b, keep, 0.5, f"M={M} K={K} N={N} r={r} {kind} {dtype}")
                        note("sparse_lora_apply", e5)
                        note("sparse_lora_apply_packed", e6)
                        paths[(r, N, dtype)] = sparse_lora.resident_stages(K, N, r, dtype)
        # x off a 16-byte boundary, and more row tiles than the ring holds
        a, b, keep = client_lora(c0, "wq", OPS_LAYERS[1])
        K = a.shape[0]
        x = torch.empty(4096 * K + 1, dtype=torch.bfloat16, device="cuda")[1:].view(4096, K)
        x.copy_(randn(4096, K))
        for xx in (x, randn(16 * 132 * 6 + 5, K).bfloat16()):
            e5, e6 = drive_lora(ops, ref, xx, a, b, keep, scale, f"wq x {tuple(xx.shape)} at {xx.data_ptr() % 16}")
            note("sparse_lora_apply", e5)
            note("sparse_lora_apply_packed", e6)
        # inf and nan in b's frozen columns: B6 never reads them (0 there, as
        # the JAX packed op gives), B5 multiplies them by 0 (nan, as JAX's does)
        for a_r, b_r in ((a, b), (randn(K, 64), randn(64, b.shape[1]))):  # the resident and the L2 kernel
            bad = b_r.clone()
            bad[:, keep == 0] = float("nan")
            bad[0, keep == 0] = float("inf")
            yp = ops.sparse_lora_apply_packed(x, a_r, bad, keep, scale)
            what = f"B6 r={b_r.shape[0]} non-finite frozen b"
            check_frozen_zero(yp, keep == 0, what)
            plain = ref.sparse_lora_apply_packed_ref(x, a_r, bad, keep, scale)
            note("sparse_lora_apply_packed", check_lora(yp, plain, what))
        for shape in ((7,), (1000, 3), (24, 7, 131)):
            f, g = torch.rand(shape, generator=gen, device="cuda"), randn(*shape)
            check_equal(ops.fisher_diag_update(f, g, 0.95), ref.fisher_diag_update_ref(g, f, 0.95),
                        f"B4 {shape}")
    torch.cuda.synchronize()
    log(f"B4 vs plain on the run's FIM trees (one client; {len(clients)} stacked, {n_fim} elements), "
        "g f32/bf16, and ragged sizes: bit for bit")
    log(f"B5/B6 vs plain on client 0's LoRA and rho=0.5 neuron masks: {n_lora} bf16 cases "
        f"(wq/wk/wv/wo x layers {list(OPS_LAYERS)} x M {list(OPS_ROWS)}) + f32; B6's kept columns B5's bits, "
        f"its frozen ones 0 with inf/nan in b there; B7 over the {n_ad} clients' wq adapters with out-of-range "
        "rows, (B, S, K), skewed, rows on no adapter, all out of range, all on adapter 0 (B5's bits) and A=1, "
        "64 random wq adapters (SGMV and split paths), its plan equal to the twin; all at ragged shapes, ranks "
        f"4/16/6/12: within tolerance; max abs err {errs}")
    log("B7 ring depth by shape (0: the L2 kernel):", sgmv)
    if min(list(sgmv.values())[:2]) == 0 or max(list(sgmv.values())[2:]) != 0:
        raise AssertionError(f"a multi-adapter launch took the wrong kernel: {sgmv}")
    log("B7 path of the few-row cases:", few)
    if set(few.values()) != {"few_rows"}:
        raise AssertionError(f"a few-row launch took another kernel: {few}")
    log("single-adapter ring depth by (r, N, dtype) at K 301 (0: a and b read from L2):",
        {f"{r},{n},{str(d)[6:]}": v for (r, n, d), v in paths.items()})
    main_widths = {(client_lora(c0, t, 0)[0].shape[0], client_lora(c0, t, 0)[1].shape[1]) for t in ("wq", "wk")}
    main = {f"K={k} N={n}": sparse_lora.resident_stages(k, n, cfg.lora_rank, torch.bfloat16) for k, n in main_widths}
    log("single-adapter ring depth at the main path's widths (bf16, rank", cfg.lora_rank, "):", main)
    if min(main.values()) == 0 or any(v != 0 for (r, _, _), v in paths.items() if r > 16):
        raise AssertionError(f"a single-adapter launch took the wrong kernel: {main}, {paths}")
    log("launches, ops phase:", run.counts)
    if run.counts != only(**{name: run.counts[name] for name in errs}) or min(run.counts[n] for n in errs) == 0:
        raise AssertionError(f"the ops phase did not launch each of its kernels: {run.counts}")
    return {name: run.counts[name] for name in errs}, errs


def graph_ms(fn, calls=20, replays=5):
    """Device time per call of ``fn(i)`` from a CUDA graph of ``calls``
    calls, replayed: the launches' host cost is left out."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def phase_ops_timing(ops, ref, fisher_diag, sparse_lora, vec, cfg, gen, tree_leaves, tree_map):
    """B4-B7 timed as phase 5b drives them, on the run's data: ``ms`` is the
    kernel through its launcher (host checks and the ctypes call included),
    ``graph_ms`` its device time from a CUDA graph of launches over inputs
    that do not fit the 50 MB L2 together, ``wrapper_ms`` the ops wrapper."""
    clients = vec.clients
    scale = cfg.lora_alpha / cfg.lora_rank
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    times = {}

    # B4 over the 8 clients' stacked FIM trees (the vectorized warmup's size)
    fim = tree_map(lambda *xs: torch.stack(xs).contiguous(), *[c.fim for c in clients])
    g = tree_map(lambda f: randn(*f.shape) * 1e-3, fim)
    fl, gl = tree_leaves(fim), tree_leaves(g)
    outs = [torch.empty_like(f) for f in fl]
    n = sum(f.numel() for f in fl)

    def b4_launch(_=0):
        for o, gg, f in zip(outs, gl, fl):
            fisher_diag.fisher_diag_launch(o, gg, f, 0.9)

    def b4_nearest():  # two foreach calls: 0.9·fim, then + 0.1·g·g
        torch._foreach_addcmul_(torch._foreach_mul(fl, 0.9), gl, gl, value=0.1)

    one, one_g = clients[0].fim, tree_map(lambda x: x[0], g)
    times["fisher_diag_update"] = dict(
        ms=cuda_ms(b4_launch), graph_ms=graph_ms(b4_launch, calls=4),
        wrapper_ms=cuda_ms(lambda: ops.fisher_diag_update(fim, g, 0.9)),
        one_client_wrapper_ms=cuda_ms(lambda: ops.fisher_diag_update(one, one_g, 0.9)),
        plain_ms=cuda_ms(lambda: tree_map(lambda f, t: ref.fisher_diag_update_ref(t, f, 0.9), fim, g)),
        # no single call: nearest torch._foreach_mul + torch._foreach_addcmul_
        library_ms=None, nearest_ms=cuda_ms(b4_nearest),
        **bound_of(12 * n, 4 * n),  # g, fim read and out written, f32
    )
    log(f"B4 timed over {len(clients)} stacked FIM trees: {n} elements, {len(fl)} leaves")

    # B5 and B6 at 4096 bf16 rows on client 0's wq (N 896) and wk (N 128)
    M = OPS_ROWS[1]
    copies = 8  # 8 x (x + y) of 7.3 MB each: more than the L2 holds
    for target in ("wq", "wk"):
        a, b, keep = (t.contiguous() for t in client_lora(clients[0], target, OPS_LAYERS[1]))
        K, r = a.shape
        N = b.shape[1]
        xs = [randn(M, K).bfloat16() for _ in range(copies)]
        ys = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _ in range(copies)]
        x = xs[0]

        def b5_launch(i=0):
            sparse_lora.sparse_lora_launch(ys[i % copies], xs[i % copies], a, b, keep, scale=scale)

        bm16, a16 = (b * keep).bfloat16(), a.bfloat16()
        entry = dict(
            ms=cuda_ms(b5_launch), graph_ms=graph_ms(b5_launch),
            wrapper_ms=cuda_ms(lambda: ops.sparse_lora_apply(x, a, b, keep, scale)),
            plain_ms=cuda_ms(lambda: ref.sparse_lora_matmul_ref(x, a, b, keep, scale)),
            # the nearest one call; it rounds x@a to bf16 between the products
            library_ms=cuda_ms(lambda: torch.linalg.multi_dot([x, a16, bm16])),
            **bound_of(2 * M * K + 2 * M * N + 4 * (K * r + r * N + N), 2 * M * K * r + 2 * M * r * N + r * N),
        )
        # the share of the byte bound that the device time reaches
        entry["bound_share"] = entry["bound_ms"] / entry["graph_ms"]
        # one client's batch (256 rows): launch latency, reported beside it
        x256, y256 = xs[0][:OPS_ROWS[0]], ys[0][:OPS_ROWS[0]]
        launch256 = lambda _=0: sparse_lora.sparse_lora_launch(y256, x256, a, b, keep, scale=scale)  # noqa: E731
        entry.update(rows256_ms=cuda_ms(launch256), rows256_graph_ms=graph_ms(launch256))
        log(f"B5 {target} at {M} bf16 rows: device {entry['graph_ms']:.4f} ms, {entry['bound_share']:.1%} of its "
            f"bound ({entry['bound_ms']:.4f} ms); launcher {entry['ms']:.4f}; at 256 rows device "
            f"{entry['rows256_graph_ms']:.4f}; ring depth {sparse_lora.resident_stages(K, N, r, torch.bfloat16)}")
        if target == "wk":
            times["sparse_lora_apply"]["wk_wv"] = entry
            continue
        times["sparse_lora_apply"] = entry

        # B6, the whole call (one launch writes all of y): its launcher, its
        # wrapper, and a CUDA graph of wrapper calls (no host sync to stop
        # the capture); wrapper times taken in turns with B5's
        def b6_launch(i=0):
            sparse_lora.sparse_lora_launch(ys[i % copies], xs[i % copies], a, b, keep, scale=scale, packed=True)

        def b6_call(i=0):
            return ops.sparse_lora_apply_packed(xs[i % copies], a, b, keep, scale)

        nk = int((keep != 0).sum())
        b6 = dict(ms=cuda_ms(b6_launch), graph_ms=graph_ms(b6_call), launcher_graph_ms=graph_ms(b6_launch),
                  plain_ms=cuda_ms(lambda: ref.sparse_lora_apply_packed_ref(x, a, b, keep, scale)),
                  # one call of the same function where b is finite: the frozen columns' b · 0
                  library_ms=entry["library_ms"], n_keep=nk,
                  **bound_of(2 * M * K + 2 * M * N + 4 * (K * r + r * nk + N), 2 * M * K * r + 2 * M * r * nk))
        b6["wrapper_ms"], b5_wrapper = paired_ms(lambda: b6_call(), lambda: ops.sparse_lora_apply(x, a, b, keep, scale))
        b6.update(bound_share=b6["bound_ms"] / b6["graph_ms"], b5_wrapper_ms=b5_wrapper,
                  vs_b5_graph=b6["graph_ms"] / entry["graph_ms"], vs_b5_wrapper=b6["wrapper_ms"] / b5_wrapper)
        times["sparse_lora_apply_packed"] = b6
        log(f"B6 wq ({nk} kept columns), the whole call: device {b6['graph_ms']:.4f} ms ({b6['vs_b5_graph']:.3f}x "
            f"B5), {b6['bound_share']:.1%} of its bound; wrapper {b6['wrapper_ms']:.4f} ({b6['vs_b5_wrapper']:.3f}x "
            f"B5's {b5_wrapper:.4f}); launcher {b6['ms']:.4f}")

    # B7: 8 adapters (the clients' wq at one layer), rows spread at random;
    # the same batch skewed to one adapter; 64 random wq-shaped adapters
    a8, b8, m8 = adapter_stack(clients, "wq", OPS_LAYERS[1])
    A, K, r = a8.shape
    N = b8.shape[2]
    xs = [randn(M, K).bfloat16() for _ in range(copies)]
    ys = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _ in range(copies)]
    x = xs[0]

    def b7_case(a_, b_, m_, idx):
        n_ad = a_.shape[0]

        def launch(i=0):
            sparse_lora.sparse_lora_launch(ys[i % copies], xs[i % copies], a_, b_, m_, idx, scale=scale)

        case = dict(graph_ms=graph_ms(launch), adapters=n_ad,
                    ring_depth=sparse_lora.resident_stages(K, N, r, torch.bfloat16, adapters=n_ad, rows=M),
                    **bound_of(2 * M * K + 2 * M * N + 4 * M + 4 * n_ad * (K * r + r * N + N),
                               2 * M * K * r + 2 * M * r * N))
        case["bound_share"] = case["bound_ms"] / case["graph_ms"]
        return launch, case

    idx = torch.randint(0, A, (M,), generator=gen, device="cuda", dtype=torch.int32)
    b7_launch, b7 = b7_case(a8, b8, m8, idx)
    b7.update(ms=cuda_ms(b7_launch),
              wrapper_ms=cuda_ms(lambda: ops.batched_sparse_lora_apply(x, idx, a8, b8, m8, scale)),
              plain_ms=cuda_ms(lambda: ref.batched_sparse_lora_matmul_ref(x, idx, a8, b8, m8, scale)),
              # no single call: nearest a gather of the adapters + torch.bmm
              library_ms=None, vs_b5_graph=b7["graph_ms"] / times["sparse_lora_apply"]["graph_ms"])
    _, b7["skewed"] = b7_case(a8, b8, m8, skewed_rows(gen, M, A).int())
    a64, b64 = randn(64, K, r) * 0.05, randn(64, r, N) * 0.05
    m64 = (torch.rand(64, N, generator=gen, device="cuda") < 0.5).float()
    _, b7["a64"] = b7_case(a64, b64, m64, torch.randint(0, 64, (M,), generator=gen, device="cuda", dtype=torch.int32))
    times["batched_sparse_lora_apply"] = b7
    log(f"B7 at {M} bf16 rows, {A} adapters: device {b7['graph_ms']:.4f} ms ({b7['vs_b5_graph']:.3f}x B5 wq), "
        f"{b7['bound_share']:.1%} of its bound ({b7['bound_ms']:.5f} ms); skewed {b7['skewed']['graph_ms']:.4f} "
        f"({b7['skewed']['bound_share']:.1%}); A=64 {b7['a64']['graph_ms']:.4f} ({b7['a64']['bound_share']:.1%}); "
        f"launcher {b7['ms']:.4f}, wrapper {b7['wrapper_ms']:.4f}")
    log("ops kernel times:", json.dumps(times))
    return times


def attention_pairs(S, causal, window):
    """The (query, key) pairs that the masks leave, for one head of one sequence."""
    i = np.arange(S, dtype=np.int64)
    hi = i + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(S, dtype=np.int64)
    return int(np.sum(hi - lo))


def attention_bound(B, S, H, KVH, D, causal, window, dtype):
    """B8's bound: q, k, v read and o written once; 4·D flops per pair and
    query head (q·k and p·v) at the inputs' type's peak (bf16 tensor cores,
    or f32), with the f32 line that a CUDA-core kernel cannot beat."""
    size = torch.finfo(dtype).bits // 8
    bytes_moved = size * B * S * D * (2 * H + 2 * KVH)
    flops = 4 * D * B * H * attention_pairs(S, causal, window)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return dict(**bound_of(bytes_moved, flops, rate), f32_line_ms=flops / F32_FLOPS_PER_S * 1e3,
                gflop=flops / 1e9)


def check_attention(out, plain, v, what):
    """B8 against its plain version at the tolerance stated at ``ATTN_REL``.
    Returns the max abs error."""
    if out.dtype != plain.dtype or out.shape != plain.shape:
        raise AssertionError(f"{what}: {out.dtype} {tuple(out.shape)} vs {plain.dtype} {tuple(plain.shape)}")
    o, p = out.float(), plain.float()
    allowed = ATTN_REL * v.float().abs().max()
    if out.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(o.abs(), p.abs()))
        allowed = allowed + torch.ldexp(torch.ones_like(o), e - 8)
    err = (o - p).abs()
    if not bool((err <= allowed).all()) or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond tolerance")
    return err.max().item()


def plain_attention(ref, q, k, v, causal, window):
    """The plain version, whole or (for long S) by slices of query rows, so
    that no S×S matrix exists at once."""
    S = q.shape[1]
    if S <= 4096:
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    return torch.cat([ref.flash_attention_gqa_ref(q[:, r:r + ATTN_SLICE], k, v, causal=causal, window=window,
                                                  q_offset=r) for r in range(0, S, ATTN_SLICE)], dim=1)


def check_ssd(y, plain, terms, a, what):
    """B9 against its plain version at the tolerance stated at ``SSD_REL``;
    ``terms`` is the plain version on |x|, |b|, |c|. Returns the max abs error."""
    if y.dtype != torch.float32 or y.shape != plain.shape:
        raise AssertionError(f"{what}: {y.dtype} {tuple(y.shape)}")
    cs_max = a.float().sum(dim=-1).abs().max()
    err = (y - plain).abs()
    if not bool((err <= (SSD_REL + SSD_CS_REL * cs_max) * terms).all()) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond tolerance")
    return err.max().item()


def layer0_qkv(vec, cfg):
    """q, k, v of layer 0 of the vectorized run's model (its global LoRA) on
    client 0's first curriculum batch, through the port's layer functions."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_rope

    c0 = vec.clients[0]
    tokens = vec._client_batch(c0, c0.batches[int(c0.order[0])])["tokens"]
    p0 = {k: v[0] for k, v in vec.params["layers"].items()}
    lora0 = {t: {n: x[0] for n, x in ab.items()} for t, ab in vec.global_lora["layers"].items()}
    x = tf._norm(torch.nn.functional.embedding(tokens, vec.params["embed"]), p0, "attn_norm", cfg.norm)
    q, k, v = tf._project_qkv(x, p0, lora0, cfg, cfg.lora_alpha / cfg.lora_rank)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    q = apply_rope(q, positions, theta=cfg.rope_theta, mode=cfg.rope)
    k = apply_rope(k, positions, theta=cfg.rope_theta, mode=cfg.rope)
    return q, k, v


def attention_cases(vec, cfg, gen):
    """Phase 5c's B8 inputs: name -> (q, k, v, causal, window)."""
    H, KVH, D = ATTN_HEADS
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = layer0_qkv(vec, cfg)
    cases = {"layer0_batch": (q, k, v, True, cfg.attention_window)}
    cases["s4096_causal"] = (randn(1, 4096, H, D), randn(1, 4096, KVH, D), randn(1, 4096, KVH, D), True, None)
    S = 16384
    cases["s16384_window8192"] = (randn(1, S, H, D), randn(1, S, KVH, D), randn(1, S, KVH, D), True,
                                  cfg.attention_window)
    f32 = dict(dtype=torch.float32)
    cases["f32_s2000_window1000_d128"] = (randn(1, 2000, H, 128, **f32), randn(1, 2000, KVH, 128, **f32),
                                          randn(1, 2000, KVH, 128, **f32), True, 1000)
    return cases


def attention_d80_cases(gen):
    """Phase 5c's B8 inputs at stablelm-3b's head_dim 80 (32 heads, MHA):
    bf16 at its 4x1024 serve prefill shape under the model's 8192 window,
    and f32 at a ragged S 2000 with window 1000."""
    H, D = D80_HEADS, 80
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    f32 = dict(dtype=torch.float32)
    return {"d80_bf16_4x1024_window8192": tuple(randn(4, 1024, H, D) for _ in range(3)) + (True, 8192),
            "d80_f32_s2000_window1000": tuple(randn(1, 2000, H, D, **f32) for _ in range(3)) + (True, 1000)}


def attention_d112_cases(gen):
    """Phase 5c's B8 inputs at zamba2-7b's head_dim 112 (32 heads, MHA): bf16
    at its 4x1024 serve prefill shape, causal with no window (the shared
    block has none), and f32 at a ragged S 2000 with window 1000."""
    H, D = D112_HEADS, 112
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    f32 = dict(dtype=torch.float32)
    return {"d112_bf16_4x1024_causal": tuple(randn(4, 1024, H, D) for _ in range(3)) + (True, None),
            "d112_f32_s2000_window1000": tuple(randn(1, 2000, H, D, **f32) for _ in range(3)) + (True, 1000)}


def attention_d256_cases(gen):
    """Phase 5c's B8 inputs at paligemma-3b's head_dim 256 (8 query heads
    over 1 KV head): bf16 at its 4x1280 serve prefill shape under the
    model's 8192 window, and f32 at a ragged S 2000 with window 1000."""
    (H, KVH), (B, S) = D256_HEADS, D256_SHAPE
    randn = lambda *s, dtype=torch.bfloat16: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    f32 = dict(dtype=torch.float32)
    return {"d256_bf16_4x1280_window8192": (randn(B, S, H, 256), randn(B, S, KVH, 256), randn(B, S, KVH, 256), True,
                                            8192),
            "d256_f32_s2000_window1000": (randn(1, 2000, H, 256, **f32), randn(1, 2000, KVH, 256, **f32),
                                          randn(1, 2000, KVH, 256, **f32), True, 1000)}


def attention_bidirectional_cases(gen):
    """Phase 5c's B8 inputs without a mask (``causal=False``) at the
    encoders' widths (``BIDIRECTIONAL``), bf16, head_dim 64."""
    return {f"{name}_bf16_{B}x{S}_bidirectional": tuple(torch.randn(B, S, H, 64, generator=gen, device="cuda").bfloat16()
                                                        for _ in range(3)) + (False, None)
            for name, (B, S, H) in BIDIRECTIONAL.items()}


def ssd_inputs(gen, dtype, B=1, S=SSD_WIDTHS["S"], heads=1, widths=SSD_WIDTHS):
    """B9's inputs at mamba2-1.3b's widths, laid out as the model hands them
    to the kernel: groups (batch, chunk, head), b and c shared by the heads,
    x already scaled by dt, decays a = -exp(A_log)·dt with A from 1 to 16
    over the heads and dt log-uniform in [1e-3, 0.1], as the initializer
    draws them. ``heads=1`` expands b and c to every group (the JAX
    kernel's contract); ``heads=nh`` keeps one row a chunk, as the model's
    prefill launches it. ``widths`` gives the chunk, heads, head_dim and
    state (zamba2-7b's: ``ZAMBA2_SSD``)."""
    Q, nh, hd, N = (widths[k] for k in ("chunk", "nh", "hd", "N"))
    nc = S // Q
    A = torch.linspace(1.0, 16.0, nh, device="cuda")
    u = torch.rand(B, S, nh, generator=gen, device="cuda")
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a = (-A * dt).reshape(B, nc, Q, nh).permute(0, 1, 3, 2).reshape(B * nc * nh, 1, Q).contiguous()
    x = torch.randn(B, S, nh, hd, generator=gen, device="cuda") * dt[..., None]
    x = x.reshape(B, nc, Q, nh, hd).permute(0, 1, 3, 2, 4).reshape(B * nc * nh, Q, hd).contiguous()
    b, c = (torch.randn(B, nc, 1, Q, N, generator=gen, device="cuda").expand(B, nc, nh // heads, Q, N)
            .reshape(B * nc * nh // heads, Q, N).contiguous() for _ in range(2))
    return x.to(dtype), a, b.to(dtype), c.to(dtype)


def ssd_model_layout(x, a, b, c, B, S, heads, Q):
    """``ssd_inputs``' groups as the model holds them: x (B, S, nh, hd), the
    decays (B, S, nh), b and c column slices of one (B, S, 8 + 2N) tensor
    (the conv's output holds x's channels before them)."""
    nc, hd, N = S // Q, x.shape[-1], b.shape[-1]
    xs = x.reshape(B, nc, heads, Q, hd).permute(0, 1, 3, 2, 4).reshape(B, S, heads, hd).contiguous()
    a_s = a.reshape(B, nc, heads, Q).permute(0, 1, 3, 2).reshape(B, S, heads).contiguous()
    bc = torch.zeros(B, S, 8 + 2 * N, dtype=b.dtype, device=b.device)
    bc[..., 8:8 + N] = b.reshape(B, S, N)
    bc[..., 8 + N:] = c.reshape(B, S, N)
    return xs, a_s, bc[..., 8:8 + N], bc[..., 8 + N:]


def ssd_bound(x, a, b, heads):
    """B9's bound: x, a, b and c read once (b and c once a row: shared by
    ``heads`` groups), y written in f32; c·b once a row, exp·score and M·x
    per group, on the triangle, at the inputs' type's peak."""
    G, Q, hd = x.shape
    N = b.shape[-1]
    pairs = Q * (Q + 1) // 2
    bytes_moved = x.element_size() * (G * Q * hd + 2 * (G // heads) * Q * N) + a.element_size() * G * Q + 4 * G * Q * hd
    flops = (G // heads) * pairs * 2 * N + G * (pairs * (2 * hd + 2) + Q)
    rate = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return dict(**bound_of(bytes_moved, flops, rate), gflop=flops / 1e9, mb=bytes_moved / 1e6)


def log_b8_layout(flash_attention, D):
    """B8's launch layout at head_dim ``D`` as the library reports it: query
    rows a block, keys a tile, ring stages, the row width in shared memory,
    threads, shared memory opted into, registers a thread at launch and
    spilled bytes (bf16: the wgmma kernel, whose consumers raise their
    registers to 240 with setmaxnreg; f32: the CUDA-core kernel)."""
    for dtype in (torch.bfloat16, torch.float32):
        lay = flash_attention.layout(D, dtype)
        log(f"B8 D {D} {str(dtype).split('.')[-1]}: {lay['query_rows']} query rows x {lay['key_tile']}-key tiles, "
            f"{lay['stages']} stages, rows of {lay['smem_width']} in shared memory, {lay['threads']} threads, "
            f"{lay['smem_bytes']} bytes of shared memory, {lay['registers']} registers at launch, "
            f"{lay['local_bytes']} bytes spilled")


def log_b9_layout(ssd_chunk, name, dtype, rows, heads):
    """B9's launch layout for ``rows`` rows of ``heads`` heads as the
    library reports it."""
    lay = ssd_chunk.layout(dtype, rows, heads)
    log(f"B9 {name} layout: {lay['rows']}-row tiles, {lay['state_columns']} state columns a b/c stage, "
        f"{lay['bc_stages']} b/c and {lay['x_stages']} x stages a consumer, head block {lay['head_block']} "
        f"({lay['units']} units on {lay['blocks']} blocks), {lay['threads']} threads, {lay['smem_bytes']} bytes "
        f"of shared memory, {lay['registers']} registers at launch, {lay['local_bytes']} bytes spilled")
    return lay


def phase_attention_ssd(ops, ref, flash_attention, ssd_chunk, vec, cfg, gen):
    """Phase 5c: B8 and B9 through ``repro_torch.kernels.ops`` against their
    plain versions. Returns the launch counts, the max abs errors and the
    inputs of the timed cases."""
    errs = {"flash_attention": 0.0, "flash_attention_d80": 0.0, "flash_attention_d112": 0.0,
            "flash_attention_d256": 0.0, "ssd_chunk_intra": 0.0}
    cases = {**attention_cases(vec, cfg, gen), **attention_bidirectional_cases(gen)}
    d80 = attention_d80_cases(gen)
    d112 = attention_d112_cases(gen)
    d256 = attention_d256_cases(gen)
    # name -> (x, a, b, c, heads): mamba2-1.3b's widths with b and c per
    # group, and zamba2-7b's with its 112 heads sharing them
    zb, znh = ZAMBA2_SSD["B"], ZAMBA2_SSD["nh"]
    ssd = {"f32": ssd_inputs(gen, torch.float32) + (1,), "bf16": ssd_inputs(gen, torch.bfloat16) + (1,),
           "zamba2_f32": ssd_inputs(gen, torch.float32, B=zb, S=ZAMBA2_SSD["S"], heads=znh, widths=ZAMBA2_SSD) + (znh,),
           "zamba2_bf16": ssd_inputs(gen, torch.bfloat16, B=zb, S=ZAMBA2_SSD["S"], heads=znh, widths=ZAMBA2_SSD)
           + (znh,)}
    # mamba2-1.3b's serve prefill in the model's layout: (groups' x, a, b, c,
    # heads) for the bound and the check's |cs|, and the model's views
    sb, ss, snh = SSD_SERVE["B"], SSD_SERVE["S"], SSD_WIDTHS["nh"]
    serve = ssd_inputs(gen, torch.bfloat16, B=sb, S=ss, heads=snh) + (snh,)
    serve_views = ssd_model_layout(*serve[:4], sb, ss, snh, SSD_WIDTHS["chunk"])

    def attention(name, q, k, v, causal, window, key):
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = plain_attention(ref, q, k, v, causal, window)
        e = check_attention(out, plain, v, f"B8 {name} {tuple(q.shape)} {q.dtype}")
        log(f"B8 {name}: q {tuple(q.shape)} {q.dtype}, causal {causal}, window {window}: max abs err {e:.3g}")
        errs[key] = max(errs[key], e)

    with Launches(ops) as run80:
        for name, case in d80.items():
            attention(name, *case, "flash_attention_d80")
    if run80.counts != only(flash_attention=len(d80)):
        raise AssertionError(f"phase 5c's D 80 cases did not launch B8 once each: {run80.counts}")
    log_b8_layout(flash_attention, 80)
    with Launches(ops) as run112:
        for name, case in d112.items():
            attention(name, *case, "flash_attention_d112")
    if run112.counts != only(flash_attention=len(d112)):
        raise AssertionError(f"phase 5c's D 112 cases did not launch B8 once each: {run112.counts}")
    log_b8_layout(flash_attention, 112)
    with Launches(ops) as run256:
        for name, case in d256.items():
            attention(name, *case, "flash_attention_d256")
    if run256.counts != only(flash_attention=len(d256)):
        raise AssertionError(f"phase 5c's D 256 cases did not launch B8 once each: {run256.counts}")
    log_b8_layout(flash_attention, 256)
    for D in (64, 128):
        log_b8_layout(flash_attention, D)
    with Launches(ops) as run:
        for name, case in cases.items():
            attention(name, *case, "flash_attention")
        copies = ssd_chunk.copy_route_launches()
        for name, (x, a, b, c, heads) in ssd.items():
            y = ops.ssd_chunk_intra(x, a, b, c, heads=heads)
            e = check_ssd(y, ref.ssd_chunk_intra_ref(x, a, b, c, heads),
                          ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs(), heads), a, f"B9 {name}")
            log(f"B9 {name}: x {tuple(x.shape)}, b/c {tuple(b.shape)}, heads {heads}: max abs err {e:.3g}")
            errs["ssd_chunk_intra"] = max(errs["ssd_chunk_intra"], e)
        Q = SSD_WIDTHS["chunk"]
        y = ops.ssd_chunk_intra_seq(*serve_views, Q)
        e = check_ssd(y, ref.ssd_chunk_intra_seq_ref(*serve_views, Q),
                      ref.ssd_chunk_intra_seq_ref(serve_views[0].abs(), serve_views[1], serve_views[2].abs(),
                                                  serve_views[3].abs(), Q), serve[1], "B9 serve_prefill")
        log(f"B9 serve_prefill (the model's layout, b and c column slices): x {tuple(serve_views[0].shape)}, "
            f"b/c {tuple(serve_views[2].shape)} at row stride {serve_views[2].stride(1)}: max abs err {e:.3g}")
        errs["ssd_chunk_intra"] = max(errs["ssd_chunk_intra"], e)
        if ssd_chunk.copy_route_launches() != copies:
            raise AssertionError("B9: a main or served shape did not take the TMA route")
        for Q, hd, N in SSD_SMALL + SSD_RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(4, Q, hd, generator=gen, device="cuda").to(dtype)
                a = -torch.randn(4, 1, Q, generator=gen, device="cuda").abs() * 0.1
                a = a.to(dtype) if (Q, hd, N) in SSD_RAGGED else a  # a in bf16 too
                b, c = (torch.randn(4, Q, N, generator=gen, device="cuda").to(dtype) for _ in range(2))
                y = ops.ssd_chunk_intra(x, a, b, c)
                e = check_ssd(y, ref.ssd_chunk_intra_ref(x, a, b, c),
                              ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs()), a, f"B9 {(Q, hd, N)} {dtype}")
                errs["ssd_chunk_intra"] = max(errs["ssd_chunk_intra"], e)
    torch.cuda.synchronize()
    log(f"B8/B9 vs plain: within tolerance; max abs err {errs}; launches, phase 5c: {run.counts}")
    if run.counts != only(flash_attention=len(cases), ssd_chunk_intra=len(ssd) + 1 + 2 * len(SSD_SMALL + SSD_RAGGED)):
        raise AssertionError(f"phase 5c did not launch each of its kernels once per case: {run.counts}")
    counts = {name: run.counts[name] for name in ("flash_attention", "ssd_chunk_intra")}
    counts["flash_attention_d80"] = run80.counts["flash_attention"]
    counts["flash_attention_d112"] = run112.counts["flash_attention"]
    counts["flash_attention_d256"] = run256.counts["flash_attention"]
    ssd["serve_prefill"] = serve + (serve_views,)
    return counts, errs, {**cases, **d80, **d112, **d256}, ssd


def library_ms(fn, big):
    """Time of one PyTorch call (a yardstick the port never calls). For a
    long sequence the unfused math backend, which would hold S×S scores for
    every head, is left out; a call that no other backend takes is not
    timed (None)."""
    if not big:
        return cuda_ms(fn, iters=20, warmup=1)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
            return cuda_ms(fn, iters=5, warmup=1)
    except RuntimeError as err:
        log(f"library call not timed: {str(err).splitlines()[0]}")
        return None


def attention_timing(ops, ref, flash_attention, name, q, k, v, causal, window):
    """One of phase 5c's B8 cases timed: ``ms`` the kernel through its
    launcher, ``graph_ms`` its device time from a CUDA graph of launches,
    ``wrapper_ms`` the ops wrapper, ``plain_ms`` the plain version (by slices
    of query rows at S 16384), ``library_ms`` ``scaled_dot_product_attention``
    on the same function, its TFLOP/s and share of its bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    launch = lambda _=0: flash_attention.flash_attention_launch(out, q, k, v, causal=causal,  # noqa: E731
                                                                   window=window)
    big = S > 4096
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    entry = dict(
        ms=cuda_ms(launch, iters=5 if big else 20, warmup=1),
        graph_ms=graph_ms(launch, calls=2 if big else 5, replays=3),
        wrapper_ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                           iters=5 if big else 20, warmup=1),
        plain_ms=cuda_ms(lambda: plain_attention(ref, q, k, v, causal, window), iters=2, warmup=1),
        **attention_bound(B, S, H, k.shape[2], D, causal, window, q.dtype),
    )
    if window is None or window >= S:
        entry["library_ms"] = library_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True), big)
    else:
        # the same function as one call: the causal window as a boolean mask
        pos = torch.arange(S, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        entry["library_ms"] = library_ms(lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True), big)
        # beside it, the causal call without the window: more work, the flash path
        entry["library_causal_ms"] = library_ms(
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), big)
        del band
    # the attention's own operations per second, and the share of the
    # bound (bf16 tensor cores, or the f32 line) that the device time reaches
    entry["tflops"] = entry["gflop"] / entry["graph_ms"]
    entry["bound_share"] = entry["bound_ms"] / entry["graph_ms"]
    log(f"B8 {name} {q.dtype}: device {entry['graph_ms']:.4f} ms, {entry['tflops']:.1f} TFLOP/s, "
        f"{entry['bound_share']:.1%} of its bound ({entry['bound_ms']:.4f} ms); "
        f"scaled_dot_product_attention {entry['library_ms']} ms")
    return entry


def phase_attention_ssd_timing(ops, ref, flash_attention, ssd_chunk, cases, ssd):
    """B8 and B9 timed on phase 5c's inputs (B8: ``attention_timing``; B9:
    ``ms`` the kernel through its launcher, ``graph_ms`` its device time
    from a CUDA graph, ``wrapper_ms``, ``plain_ms``, and no library call)."""
    bidirectional = [f"{name}_bf16_{B}x{S}_bidirectional" for name, (B, S, _) in BIDIRECTIONAL.items()]
    entries = {name: attention_timing(ops, ref, flash_attention, name, *cases[name]) for name in
               ["s4096_causal", "s16384_window8192", "f32_s2000_window1000_d128", "d80_bf16_4x1024_window8192",
                "d80_f32_s2000_window1000", "d112_bf16_4x1024_causal", "d112_f32_s2000_window1000",
                "d256_bf16_4x1280_window8192", "d256_f32_s2000_window1000"] + bidirectional}
    times = {"flash_attention": dict(entries["s4096_causal"], s16384_window8192=entries["s16384_window8192"],
                                     f32_s2000_window1000_d128=entries["f32_s2000_window1000_d128"]),
             "flash_attention_d80": dict(entries["d80_bf16_4x1024_window8192"],
                                         f32_s2000_window1000=entries["d80_f32_s2000_window1000"]),
             "flash_attention_d112": dict(entries["d112_bf16_4x1024_causal"],
                                          f32_s2000_window1000=entries["d112_f32_s2000_window1000"]),
             "flash_attention_d256": dict(entries["d256_bf16_4x1280_window8192"],
                                          f32_s2000_window1000=entries["d256_f32_s2000_window1000"])}
    for name in bidirectional:
        times["flash_attention"][name] = entries[name]

    ssd_entries = {}
    for name, (x, a, b, c, heads, *views) in ssd.items():
        G, Q = x.shape[:2]
        if views:  # the model's layout (the serve prefill): the views the prefill hands the kernel
            (xs, a_s, bs, cs_), = views
            ys = torch.empty(xs.shape, dtype=torch.float32, device="cuda")
            rows = lambda t: t.unflatten(1, (t.shape[1] // Q, Q)).flatten(0, 1)  # noqa: E731
            args = (rows(ys).transpose(1, 2), rows(xs).transpose(1, 2), rows(a_s).transpose(1, 2), rows(bs), rows(cs_))
            launch = lambda _=0: ssd_chunk.ssd_chunk_launch_views(*args)  # noqa: E731
            wrapper = lambda: ops.ssd_chunk_intra_seq(xs, a_s, bs, cs_, Q)  # noqa: E731
            plain = lambda: ref.ssd_chunk_intra_seq_ref(xs, a_s, bs, cs_, Q)  # noqa: E731
        else:
            y = torch.empty(x.shape, dtype=torch.float32, device="cuda")
            launch = lambda _=0: ssd_chunk.ssd_chunk_launch(y, x, a, b, c, heads)  # noqa: E731
            wrapper = lambda: ops.ssd_chunk_intra(x, a, b, c, heads=heads)  # noqa: E731
            plain = lambda: ref.ssd_chunk_intra_ref(x, a, b, c, heads)  # noqa: E731
        lay = log_b9_layout(ssd_chunk, name, x.dtype, G // heads, heads)
        ssd_entries[name] = dict(
            ms=cuda_ms(launch), graph_ms=graph_ms(launch, calls=5, replays=3), wrapper_ms=cuda_ms(wrapper),
            plain_ms=cuda_ms(plain, iters=10, warmup=1),
            # no single call; the plain version is the nearest einsum chain
            library_ms=None, heads=heads, state=b.shape[-1], head_block=lay["head_block"],
            **ssd_bound(x, a, b, heads),
        )
        e = ssd_entries[name]
        e["bound_share"] = e["bound_ms"] / e["graph_ms"]
        log(f"B9 {name} ({G} groups, heads {heads}, state {b.shape[-1]}): device {e['graph_ms']:.4f} ms, "
            f"{e['bound_share']:.1%} of its bound ({e['bound_ms']:.4f} ms, {e['bound_by']}); launcher {e['ms']:.4f}, "
            f"plain {e['plain_ms']:.4f}")
    times["ssd_chunk_intra"] = dict(ssd_entries["f32"], bf16=ssd_entries["bf16"], zamba2_f32=ssd_entries["zamba2_f32"],
                                    zamba2_bf16=ssd_entries["zamba2_bf16"], serve_prefill=ssd_entries["serve_prefill"])
    log("B8/B9 times:", json.dumps(times))
    return times


def lora_left_out(lora):
    """A LoRA tree with every group empty: the base model alone."""
    return {group: {} for group in lora}


def slot_leaves(lora_t):
    """The per-slot LoRA factors of the first layer of every target of a
    gathered tree: name -> (a (B, d_in, r), b (B, r, d_out)). A stacked
    group's leaves are (L, B, ...), an unstacked one's (the hybrid's shared
    block) (B, ...); targets outside the "layers" group are named
    "group/target"."""
    out = {}
    for group, targets in lora_t.items():
        for t, ab in targets.items():
            a, b = ab["a"], ab["b"]
            if a.dim() == 4:
                a, b = a[0], b[0]
            out[t if group == "layers" else f"{group}/{t}"] = (a, b)
    return out


def prefix_rows(cfg):
    """The positions before a request's tokens: a vlm's prefix rows."""
    return cfg.num_prefix_embeddings if cfg.family == "vlm" else 0


def request_extras(cfg):
    """``extras(i)``: request i's own seeded N(0, 1) frame (encoder-decoder)
    or patch (vlm) embeddings, bf16 on the card; None for the other
    families."""
    shape = {"audio": ("encoder_embeds", cfg.encoder_seq_len), "encdec": ("encoder_embeds", cfg.encoder_seq_len),
             "vlm": ("prefix_embeds", cfg.num_prefix_embeddings)}.get(cfg.family)
    if shape is None:
        return None

    def extras(i):
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        return {shape[0]: torch.randn(shape[1], cfg.d_model, generator=gen, device="cuda").bfloat16()}

    return extras


def serve_requests(Request, SamplingParams, cfg, eos=None, spec=SERVE_REQUESTS):
    """Phase 5d's requests (or ``spec``'s), prompts drawn from a seeded
    numpy generator, each with its own extras where the family takes them
    (``request_extras``)."""
    rng = np.random.default_rng(19)
    extras = request_extras(cfg)
    reqs = []
    for i, (S, budget, adapter) in enumerate(spec):
        sampling = SamplingParams(
            max_new_tokens=budget, seed=100 + i,
            temperature=SERVE_TEMPERATURE if i == SERVE_SAMPLED else 0.0,
            eos_id=eos if i == SERVE_EOS else None,
        )
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, S).astype(np.int32), sampling=sampling,
                            adapter_id=adapter, extras=extras(i) if extras else None))
    return reqs


def recording_engine(ServeEngine, model):
    """A ServeEngine whose model keeps, for every request, the logits from
    which each of its tokens was drawn: ``logits[(request_id, j)]`` for its
    token j (prefill gives token 0; the decode of token j-1 gives token j).
    It reads the slots' positions on the host at every decode step (a sync
    that leaves the results as they are; a vlm's positions count its prefix
    rows), and records the prefill groups' shapes."""
    logits, groups, holder = {}, [], {}
    first_pos = prefix_rows(model.cfg)

    def prefill(params, lora, batch, cache_len):
        out, cache, S = model.prefill(params, lora, batch, cache_len)
        for row, r in enumerate(holder["group"]):
            logits.setdefault((r.request_id, 0), out[row, -1].clone())
        return out, cache, S

    def decode_step(params, lora, token, cache, position):
        out, cache = model.decode_step(params, lora, token, cache, position)
        pos = position.tolist()
        for slot, r in holder["engine"].scheduler._busy.items():
            logits.setdefault((r.request_id, pos[slot] - first_pos - len(r.tokens) + 1), out[slot, -1].clone())
        return out, cache

    class Recording(ServeEngine):
        def _admit_group_body(self, slots, reqs):
            holder["group"] = reqs
            groups.append((len(reqs), len(reqs[0].tokens)))
            super()._admit_group_body(slots, reqs)

    def make(*args, **kw):
        eng = Recording(dataclasses.replace(model, prefill=prefill, decode_step=decode_step), *args, **kw)
        holder["engine"] = eng
        return eng

    return make, logits, groups


def serve_all(engine, reqs):
    """Submit ``reqs``, drain the engine; the completions in request order."""
    rids = [engine.submit(r) for r in reqs]
    comps = {c.request_id: c for c in engine.drain()}
    return [comps[i] for i in rids]


def serve_oracle(model, params, adapters, reqs, comps, logits, rel, f32=False):
    """Each completion against the teacher-forced training forward (plain,
    no kernel, no cache) over prompt + emitted tokens with its adapter, at
    every emitted position. A position's error is its largest |served -
    oracle| over its row's largest |oracle|, and the tolerance is ``rel``.
    With ``f32`` the oracle is that forward in f32 (params widened; main()
    turns TF32 off) and the tolerance is ``rel`` times the floor: the
    largest error of the plain bf16 forward itself, on the same measure at
    the same positions. A greedy token may differ from the oracle's argmax
    only at a near-tie (the two within the tolerance). Two controls read
    the served logits against the oracle with the LoRA left out and with
    the next adapter in place of the request's own: what the check would
    read if the served path dropped or misrouted the delta; each must read
    above 1 for every request. Requests with ``extras`` (frame or patch
    embeddings) feed them to the forward, and a third control reads the
    forward with the next request's extras. Returns the readings, errors
    and controls as shares of the tolerance (the prefill's token and the
    decode steps' apart)."""
    from repro_torch.utils.tree import tree_map

    ref_params = tree_map(lambda x: x.float(), params) if f32 else params
    dtype = torch.float32 if f32 else torch.bfloat16
    P = prefix_rows(model.cfg)
    rows = []
    for i, (r, c) in enumerate(zip(reqs, comps)):
        S = P + len(r.tokens)
        seq = torch.as_tensor(np.concatenate([r.tokens, c.tokens[:-1]]).astype(np.int64), device="cuda")
        other = reqs[(i + 1) % len(reqs)].extras

        def at(p, lora, extras=r.extras, S=S, c=c, seq=seq):
            batch = {"tokens": seq[None], **{k: v[None].to(dtype) for k, v in (extras or {}).items()}}
            with torch.no_grad():
                full, _ = model.forward(p, lora, batch)
            return full[0, S - 1:S - 1 + c.steps].float()

        got = torch.stack([logits[(c.request_id, j)] for j in range(c.steps)]).float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"serve request {c.request_id}: non-finite logits")
        own, nxt = adapters[r.adapter_id], adapters[(r.adapter_id + 1) % len(adapters)]
        rows.append((r, c, got, at(ref_params, own), at(params, own) if f32 else None,
                     at(ref_params, lora_left_out(own)), at(ref_params, nxt),
                     at(ref_params, own, other) if other else None))
    del ref_params

    def err(x, want):
        return (x - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)

    floor = max(float(err(plain, want).max()) for _, _, _, want, plain, _, _, _ in rows) if f32 else None
    tol_rel = rel * floor if f32 else rel
    out = dict(positions=0, worst=0.0, worst_prefill=0.0, worst_decode=0.0, flips=0, ties=0)
    off, swapped, mixed = [], [], []
    for r, c, got, want, _, want_off, want_next, want_other in rows:
        e = err(got, want) / tol_rel
        if float(e.max()) > 1.0:
            raise AssertionError(f"serve request {c.request_id}: logits {float(e.max()):.3f}x the tolerance "
                                 f"({tol_rel:.4g} of a row's largest |logit|) from the oracle")
        out["worst"] = max(out["worst"], float(e.max()))
        out["worst_prefill"] = max(out["worst_prefill"], float(e[0]))
        if c.steps > 1:
            out["worst_decode"] = max(out["worst_decode"], float(e[1:].max()))
        out["positions"] += c.steps
        if r.sampling.temperature == 0.0:
            tol = tol_rel * want.abs().amax(dim=-1)
            served = torch.as_tensor(c.tokens.astype(np.int64), device="cuda")
            gap = want.amax(dim=-1) - want.gather(1, served[:, None])[:, 0]
            if bool((gap > tol).any()):
                raise AssertionError(f"serve request {c.request_id}: a greedy token is no near-tie of the oracle's")
            out["flips"] += int((want.argmax(dim=-1) != served).sum())
            top2 = want.topk(2, dim=-1).values
            out["ties"] += int((top2[:, 0] - top2[:, 1] <= tol).sum())
        off.append(float((err(got, want_off) / tol_rel).max()))
        swapped.append(float((err(got, want_next) / tol_rel).max()))
        if want_other is not None:
            mixed.append(float((err(got, want_other) / tol_rel).max()))
    out.update(control_lora_off=min(off), control_next_adapter=min(swapped), tolerance=tol_rel)
    if mixed:
        out["control_other_extras"] = min(mixed)
    if f32:
        out["floor"] = floor
    return out


def log_oracle(label, o, what):
    log(f"{label}serve vs teacher-forced oracle ({what}): {o['positions']} positions, largest logit error "
        f"{o['worst']:.3f} of the tolerance ({o['tolerance']:.4g} of a row's largest |logit|; prefill "
        f"{o['worst_prefill']:.3f}, decode {o['worst_decode']:.3f}); greedy tokens off the oracle's argmax "
        f"(near-ties): {o['flips']}, of {o['ties']} greedy positions whose oracle top two lie within the "
        f"tolerance; controls (smallest reading over the requests): LoRA left out {o['control_lora_off']:.3f}, "
        f"the next adapter {o['control_next_adapter']:.3f}"
        + (f", the next request's extras {o['control_other_extras']:.3f}" if "control_other_extras" in o else ""))
    if o["control_lora_off"] <= 1.0 or o["control_next_adapter"] <= 1.0:
        raise AssertionError(f"the {label}oracle cannot see the adapters: a served path that dropped or misrouted "
                             f"the LoRA delta would pass it ({o['control_lora_off']:.3f}, "
                             f"{o['control_next_adapter']:.3f})")
    if o.get("control_other_extras", 2.0) <= 1.0:
        raise AssertionError(f"the {label}oracle cannot see the requests' extras: a served path that mixed them up "
                             f"would pass it ({o['control_other_extras']:.3f})")


def profiled(fn, wall_ms):
    """One call of ``fn`` under ``torch.profiler``: its kernel time, the
    device's busy share of ``wall_ms`` (the call's time unprofiled), its
    kernel count, and B7's, B8's and B9's shares of the kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in kernels)
    out = dict(kernel_ms=us / 1e3, busy_share=us / 1e3 / wall_ms, kernels=sum(e.count for e in kernels))
    for name, key in (("b7", "sparse_lora"), ("b8", "flash_attention"), ("b9", "ssd_chunk")):  # names in csrc/
        out[f"{name}_share"] = sum(e.self_device_time_total for e in kernels if key in e.key) / us if us else 0.0
    return out


def forced_b7_launch(sparse_lora, y, x, idx, a, b, mask, scale):
    """The resident (SGMV) or L2 (BGMV) kernel's launch whatever the row
    count (a launch without the few-row or split path's scratch): the
    kernel a launch of those paths took before them, timed beside them."""
    M, K = x.shape
    A, r, N = b.shape
    err = sparse_lora.library().repro_sparse_lora(
        y.data_ptr(), x.data_ptr(), idx.data_ptr(), a.data_ptr(), b.data_ptr(), mask.data_ptr(), None, None, M,
        K, N, r, A, 1 if x.dtype == torch.bfloat16 else 0, 0, scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"B7 launch failed with CUDA error {err}")


def b7_serve_entry(ops, ref, sparse_lora, lora_t, target, M, A, per, scale, err, gen):
    """B7 timed at a serve shape: ``M`` rows, ``per`` a slot, on the first
    ``A`` served adapters of ``target`` at layer 0, beside its bound (x, y
    and the row index once, each adapter's a, b and mask once) and its
    library yardstick (two ``torch.bmm`` calls over the slots, the same
    function at slot-contiguous rows, without the scale and the cast).
    Where the launch takes the few-row or the split path, the kernel it
    took before (``old_*``: BGMV, or SGMV where it fits) is timed on the
    same inputs beside it."""
    a, b = slot_leaves(lora_t)[target]
    a, b = a[:A].contiguous(), b[:A].contiguous()
    K, N, r = a.shape[1], b.shape[-1], a.shape[-1]
    ones = torch.ones(A, N, device="cuda")
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    idx = torch.arange(A, dtype=torch.int32, device="cuda").repeat_interleave(per)
    launch = lambda _=0: sparse_lora.sparse_lora_launch(y, x, a, b, ones, idx, scale=scale)  # noqa: E731
    x3, bm = x.view(A, per, K), b * ones[:, None, :]
    e = dict(target=target, rows=M, adapters=A, path=sparse_lora.batched_path(M, K, N, r, torch.bfloat16, A),
             ring_depth=sparse_lora.resident_stages(K, N, r, torch.bfloat16, adapters=A, rows=M),
             max_abs_err=err, ms=cuda_ms(launch), graph_ms=graph_ms(launch),
             wrapper_ms=cuda_ms(lambda: ops.batched_sparse_lora_apply(x, idx, a, b, ones, scale)),
             plain_ms=cuda_ms(lambda: ref.batched_sparse_lora_matmul_ref(x, idx, a, b, ones, scale)),
             library_ms=cuda_ms(lambda: torch.bmm(torch.bmm(x3.float(), a), bm)),
             library="two torch.bmm calls, the same function at slot-contiguous rows",
             **bound_of(2 * M * K + 2 * M * N + 4 * M + 4 * A * (K * r + r * N + N), 2 * M * K * r + 2 * M * r * N))
    e["bound_share"] = e["bound_ms"] / e["graph_ms"]
    if e["path"] in ("few_rows", "split"):
        old = lambda _=0: forced_b7_launch(sparse_lora, y, x, idx, a, b, ones, scale)  # noqa: E731
        e.update(old_path="sgmv" if e["ring_depth"] else "bgmv", old_graph_ms=graph_ms(old), old_ms=cuda_ms(old))
        e.update(old_bound_share=e["bound_ms"] / e["old_graph_ms"], speedup=e["old_graph_ms"] / e["graph_ms"])
    return e


def serve_phase(ops, ref, sparse_lora, model, params, adapters, make_reqs, *, cache_len, launches, oracle,
                b7_target, label="", recorder=None):
    """Serving at full width, shared by phases 5d, f, h and i: ``ServeEngine``
    on ``adapters[0]`` with the others as tenants, ``SERVE_SLOTS`` slots. The
    main run serves ``make_reqs()``, counts the launches (they must equal
    ``launches(stats)``) and records the served logits, which
    ``serve_oracle(**oracle)`` holds to the training forward (or, with a
    ``recorder`` that checks the path as it runs, ``oracle(reqs, comps,
    record)`` sums up what it recorded: phase i's MoE oracle). A run with
    telemetry must give the same tokens bit for bit; its spans time the
    path, and a decode step and the first prefill group are profiled. Then
    B7 against its plain version on the served adapters of every LoRA
    target at every shape the path gave it (each prefill group's and the
    decode shape, one row a slot), and timed on ``b7_target`` at the decode
    shape and the first group's. Returns a dict: the completions and their
    requests, the prefill groups, the launch counts, the slots' gathered
    LoRA, B7's errors and paths (``sparse_lora.batched_path``) by shape,
    the times and a seeded generator for the caller's own checks. Every
    decode shape must take B7's few-row path, and every prefill shape SGMV
    where its adapters stage and the split path elsewhere. ``launches``
    gives B7's prefill launches on either of those two paths as
    ``batched_sparse_lora_apply``; the run's count is held to it split by
    path."""
    from repro_torch.lora import gather_adapter_slots
    from repro_torch.obs import Telemetry, check_spans
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_clone

    t0 = time.perf_counter()
    cfg = model.cfg
    reqs = make_reqs()
    kw = dict(adapters=adapters[1:], cache_len=cache_len, num_slots=SERVE_SLOTS,
              max_new_cap=max(r.sampling.max_new_tokens for r in reqs))
    make, logits, groups = (recorder or recording_engine)(ServeEngine, model)
    with Launches(ops) as run:
        main = make(params, adapters[0], **kw)
        comps = serve_all(main, reqs)
    parts = {"main run": time.perf_counter() - t0}
    log(f"{label}serve main run: {len(comps)} completions, prefill groups (requests, prompt length) {groups}, "
        f"{main.stats}; launches {run.counts}")
    want = launches(main.stats)
    counted = {**run.counts, "batched_sparse_lora_apply": run.counts["batched_sparse_lora_apply"]
               + run.counts["batched_sparse_lora_split"], "batched_sparse_lora_split": 0}
    if counted != want or main.stats["completed"] != len(reqs):
        raise AssertionError(f"the {label}serve run did not go through its kernels as its path says: "
                             f"{run.counts} != {want}")
    with Launches(ops) as oracle_run:
        o = (oracle(reqs, comps, logits) if callable(oracle)
             else serve_oracle(model, params, adapters, reqs, comps, logits, **oracle))
    if any(oracle_run.counts.values()):
        raise AssertionError(f"the oracle forward launched a kernel: {oracle_run.counts}")
    del logits
    parts["oracle"] = time.perf_counter() - t0 - sum(parts.values())

    # telemetry on: the same tokens bit for bit; its spans time the path
    torch.cuda.reset_peak_memory_stats()
    tel = Telemetry(run_id=f"{label}serve")
    eng = ServeEngine(model, params, adapters[0], telemetry=tel, **kw)
    comps2 = serve_all(eng, make_reqs())
    if any(not np.array_equal(a.tokens, b.tokens) or a.finish_reason != b.finish_reason
           for a, b in zip(comps, comps2)):
        raise AssertionError(f"{label}serving with telemetry changed the tokens")
    check_spans(tel.tracer.events)
    parts["telemetry run"] = time.perf_counter() - t0 - sum(parts.values())
    snap = tel.snapshot()
    emitted = sum(c.steps for c in comps2)
    if snap["counters"]["serve.completed"] != len(comps2) or snap["counters"]["serve.tokens_emitted"] != emitted:
        raise AssertionError(f"serve counters {snap['counters']} do not match {len(comps2)} completions")
    spans = [e for e in tel.tracer.events if e["type"] == "span"]
    prefill_ms = [1e3 * e["dur"] for e in spans if e["name"] == "prefill"]
    segment_s = sum(e["dur"] for e in spans if e["name"] == "segment")
    if len(prefill_ms) != len(groups):
        raise AssertionError(f"the telemetry run made {len(prefill_ms)} prefill groups, the main run {len(groups)}")
    ttft = snap["histograms"]["serve.ttft_s"]
    st = eng._state
    lora_t = gather_adapter_slots(cfg, eng._stacked, st["aidx"])
    (g0, S0), gen = groups[0], torch.Generator(device="cuda").manual_seed(5)
    first = {"tokens": torch.randint(0, cfg.vocab_size, (g0, S0), generator=gen, device="cuda"),
             **{k: torch.stack([r.extras[k] for r in reqs[:g0]]) for k in reqs[0].extras or {}}}
    lora_g0 = gather_adapter_slots(cfg, eng._stacked, st["aidx"][:g0])
    cache = tree_clone(st["cache"])  # decode writes its cache in place
    with torch.no_grad():
        step = lambda: model.decode_step(eng.params, lora_t, st["token"], cache, st["pos"])  # noqa: E731
        step_ms = cuda_ms(step, iters=SERVE_STEP_ITERS, warmup=2)
        prefill = lambda: model.prefill(eng.params, lora_g0, first, cache_len)  # noqa: E731
        group0_ms = cuda_ms(prefill, iters=3, warmup=1)
        profiles = {"decode": profiled(step, step_ms), f"prefill {g0}x{S0}": profiled(prefill, group0_ms)}
    times = dict(
        layers=cfg.num_layers,
        prefill_groups=[dict(requests=g, prompt=S, ms=ms) for (g, S), ms in zip(groups, prefill_ms)],
        decode_steps=eng.stats["decode_steps"], segment_ms_per_step=1e3 * segment_s / eng.stats["decode_steps"],
        decode_step_ms=step_ms, tokens=emitted, useful_tokens_per_s=snap["gauges"]["serve.useful_tokens_per_s"],
        ttft_mean_ms=1e3 * ttft["mean"], ttft_max_ms=1e3 * ttft["max"],
        serve_peak_gib=torch.cuda.max_memory_allocated() / 2**30, oracle=o, first_group_prefill_ms=group0_ms,
        profiles=profiles,
    )
    del cache

    # B7 against its plain version at every shape the path gave it
    scale = cfg.lora_alpha / cfg.lora_rank
    errs, paths = {}, {}
    for g, S in sorted(set(groups)) + [(SERVE_SLOTS, 1)]:
        idx = torch.arange(g, dtype=torch.int32, device="cuda").repeat_interleave(S)
        for t, (a, b) in slot_leaves(lora_t).items():
            a, b = a[:g].contiguous(), b[:g].contiguous()
            paths[f"{t} {g}x{S}"] = sparse_lora.batched_path(g * S, a.shape[1], b.shape[-1], cfg.lora_rank,
                                                             torch.bfloat16, g)
            ones = torch.ones(g, b.shape[-1], device="cuda")
            x = torch.randn(g * S, a.shape[1], generator=gen, device="cuda").bfloat16()
            errs[f"B7 {t} {g}x{S}"] = check_lora(ops.batched_sparse_lora_apply(x, idx, a, b, ones, scale),
                                                 ref.batched_sparse_lora_matmul_ref(x, idx, a, b, ones, scale),
                                                 f"{label}B7 serve {t} {g}x{S}")
    log(f"{label}B7 path by shape: {json.dumps(paths)}")
    decode_key = f" {SERVE_SLOTS}x1"
    decode = {k: v for k, v in paths.items() if k.endswith(decode_key)}
    if set(decode.values()) != {"few_rows"}:
        raise AssertionError(f"{label}a decode shape did not take B7's few-row path: {decode}")
    prefill = {k: v for k, v in paths.items() if not k.endswith(decode_key)}
    if not set(prefill.values()) <= {"sgmv", "split"}:
        raise AssertionError(f"{label}a prefill shape whose widths do not stage did not take B7's split path: "
                             f"{prefill}")
    # each path's launches where and only where the prefill shapes take it
    for path, name in (("sgmv", "batched_sparse_lora_apply"), ("split", "batched_sparse_lora_split")):
        if (path in prefill.values()) != (run.counts[name] > 0):
            raise AssertionError(f"{label}B7's {path} launches ({run.counts[name]}) do not follow the prefill "
                                 f"paths {prefill}")

    def b7_entry(M, A, per):
        return b7_serve_entry(ops, ref, sparse_lora, lora_t, b7_target, M, A, per, scale,
                              errs[f"B7 {b7_target} {A}x{per}"], gen)

    times.update(b7_decode=b7_entry(SERVE_SLOTS, SERVE_SLOTS, 1), b7_prefill=b7_entry(g0 * S0, g0, S0))
    for name, e in ((f"B7 {b7_target} decode {SERVE_SLOTS} rows x {SERVE_SLOTS} adapters", times["b7_decode"]),
                    (f"B7 {b7_target} prefill {g0 * S0} rows x {g0} adapters", times["b7_prefill"])):
        log(f"{label}serve shape {name}: device {e['graph_ms']:.4f} ms, {e['bound_share']:.1%} of its bound "
            f"({e['bound_ms']:.5f} ms, {e['bound_by']}); launcher {e['ms']:.4f}, wrapper {e['wrapper_ms']:.4f}, "
            f"plain {e['plain_ms']:.4f}, two bmm {e['library_ms']:.4f}; path {e['path']}"
            + (f"; the {e['old_path']} kernel it replaced {e['old_graph_ms']:.4f} ms ({e['speedup']:.1f}x)"
               if "old_graph_ms" in e else ""))
    parts["timing and kernel checks"] = time.perf_counter() - t0 - sum(parts.values())
    log(f"{label}serve: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in parts.items())})")

    def path_err(path):
        return max((e for k, e in errs.items() if paths[k[3:]] == path), default=0.0)

    return dict(comps=comps, reqs=reqs, groups=groups, counts=run.counts, lora_t=lora_t, errs=errs, paths=paths,
                times=times, gen=gen, b7_err=path_err("sgmv"), split_err=path_err("split"),
                few_err=path_err("few_rows"))


def b8_serve_checks(ops, ref, flash_attention, cfg, groups, gen, label="", causal=True):
    """B8 against its plain version at every prefill group's shape of a
    dense model's serve run (``groups``: (requests, positions), a vlm's
    prefix rows included), and timed at the first group's beside its bound
    and ``scaled_dot_product_attention``'s time. ``causal=False``: an
    encoder's attention, no mask. Returns the errors by shape and the
    timed entry."""
    hd = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    w = cfg.attention_window if causal else None
    errs = {}
    for g, S in sorted(set(groups)):
        q = torch.randn(g, S, H, hd, generator=gen, device="cuda").bfloat16()
        kk, vv = (torch.randn(g, S, KVH, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
        errs[f"{g}x{S}"] = check_attention(ops.flash_attention(q, kk, vv, causal=causal, window=w),
                                           ref.flash_attention_gqa_ref(q, kk, vv, causal=causal, window=w),
                                           vv, f"{label}B8 serve prefill {g}x{S}")
    g0, S0 = groups[0]
    q = torch.randn(g0, S0, H, hd, generator=gen, device="cuda").bfloat16()
    kk, vv = (torch.randn(g0, S0, KVH, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
    out = torch.empty_like(q)
    launch = lambda _=0: flash_attention.flash_attention_launch(out, q, kk, vv, causal=causal, window=w)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    b8 = dict(head_dim=hd, causal=causal, max_abs_err=errs[f"{g0}x{S0}"], ms=cuda_ms(launch, iters=20),
              graph_ms=graph_ms(launch, calls=5, replays=3),
              wrapper_ms=cuda_ms(lambda: ops.flash_attention(q, kk, vv, causal=causal, window=w), iters=20),
              plain_ms=cuda_ms(lambda: ref.flash_attention_gqa_ref(q, kk, vv, causal=causal, window=w), iters=5),
              library_ms=library_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=causal, enable_gqa=True), False),
              **attention_bound(g0, S0, H, KVH, hd, causal, w, torch.bfloat16))
    b8.update(tflops=b8["gflop"] / b8["graph_ms"], bound_share=b8["bound_ms"] / b8["graph_ms"])
    log(f"{label}serve shape B8 prefill {g0}x{S0} (D {hd}, causal {causal}): device {b8['graph_ms']:.4f} ms, "
        f"{b8['bound_share']:.1%} of its bound ({b8['bound_ms']:.5f} ms, {b8['bound_by']}); launcher "
        f"{b8['ms']:.4f}, wrapper {b8['wrapper_ms']:.4f}, plain {b8['plain_ms']:.4f}, library {b8['library_ms']}")
    return errs, b8


def dense_serve_launches(L):
    """A dense decoder's serve launches by the engine's stats: B8 once a
    layer per prefill group; B7 on the four attention projections of every
    layer, SGMV on prefill and the few-row path on decode."""
    return lambda st: only(flash_attention=L * st["prefill_calls"],
                           batched_sparse_lora_apply=4 * L * st["prefill_calls"],
                           batched_sparse_lora_few_rows=4 * L * st["decode_steps"])


def phase_serve(ops, ref, sparse_lora, flash_attention, vec, cfg, model):
    """Phase 5d: serving qwen2-0.5b at full width on the vectorized run's
    global LoRA and three of its clients' adapters (``serve_phase``). A
    first run finds the EOS request's stop token in its greedy stream; the
    main run takes B8 on every prefill group and B7 (SGMV on prefill, the
    few-row path on decode) on the four attention projections, and its completions keep
    their budgets (clamped to the cache), the EOS stop and the sampled
    stream. Then B8 against its plain version at every prefill group's
    shape, and timed at the first group's beside its bound. Returns the
    launch counts, the kernels' largest errors and the times."""
    from repro_torch.serve import Request, SamplingParams, ServeEngine
    from repro_torch.utils.tree import tree_clone

    adapters = [tree_clone(vec.global_lora)] + [tree_clone(vec.clients[i].lora) for i in range(3)]
    t0 = time.perf_counter()
    eos, stop, probe = eos_from_probe(ServeEngine, model, vec.params, adapters,
                                      serve_requests(Request, SamplingParams, cfg), SERVE_CACHE)

    L = cfg.num_layers
    s = serve_phase(ops, ref, sparse_lora, model, vec.params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg, eos), cache_len=SERVE_CACHE,
                    launches=dense_serve_launches(L), oracle=dict(rel=SERVE_LOGIT_REL), b7_target="wq")
    comps, groups, times = s["comps"], s["groups"], s["times"]
    log_oracle("", times["oracle"], "the bf16 forward")
    if any(p != "sgmv" for key, p in s["paths"].items() if not key.endswith(f" {SERVE_SLOTS}x1")):
        raise AssertionError("B7 did not take SGMV on prefill")
    for (S, budget, _), c in zip(SERVE_REQUESTS, comps):
        if c.prompt_len != S or (c.finish_reason == "length" and c.steps != min(budget, SERVE_CACHE - S)):
            raise AssertionError(f"serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    ce = comps[SERVE_EOS]
    if ce.finish_reason != "eos" or not np.array_equal(ce.tokens, stop):
        raise AssertionError(f"the EOS request did not stop at its first {eos} ({ce.tokens} vs {stop})")
    same_sampled = np.array_equal(comps[SERVE_SAMPLED].tokens, probe[SERVE_SAMPLED].tokens)
    log(f"serve EOS request stopped at token {len(stop) - 1} ({eos}); sampled request (T {SERVE_TEMPERATURE}) equal to "
        f"its stream in the first run, whose co-residents differ after the EOS: {same_sampled}")
    log(f"serve times: {json.dumps({k: v for k, v in times.items() if not k.startswith('b7')})}")

    errs, times["b8_prefill"] = b8_serve_checks(ops, ref, flash_attention, cfg, groups, s["gen"])
    log(f"B7 and B8 vs plain at the serve shapes: within tolerance; max abs err "
        f"{json.dumps({**s['errs'], **{f'B8 {k}': e for k, e in errs.items()}})}")
    log(f"serve phase: {time.perf_counter() - t0:.1f} s")
    counts = {n: s["counts"][n] for n in ("flash_attention", "batched_sparse_lora_apply",
                                          "batched_sparse_lora_few_rows")}
    return counts, {"batched_sparse_lora_apply": s["b7_err"], "flash_attention": max(errs.values()),
                    "batched_sparse_lora_few_rows": s["few_err"]}, times


def b7_prefill_times(times, key, e):
    """A serve phase's B7 prefill entry, filed under the kernel of the path
    it took; the first split entry also gives that kernel's own numbers."""
    name = "batched_sparse_lora_split" if e["path"] == "split" else "batched_sparse_lora_apply"
    if name not in times:
        times[name] = {k: v for k, v in e.items() if k != "max_abs_err"}
    times[name][key] = e


def run_record(runner, hist, tree_clone):
    """What phase m holds a sharded run to: a run's decisions, stats, bytes,
    global LoRA and stacked client state (neuron masks, moments and
    compression state included), copied."""
    return dict(hist=[dict(h) for h in hist], comm=list(runner.comm_bytes_per_round),
                upload=list(runner.comm_upload_bytes_per_round), orders=[c.order.copy() for c in runner.clients],
                gal_layers=runner.gal_layers.copy(), global_lora=tree_clone(runner.global_lora),
                population=tree_clone(runner.population_state()))


def check_same_run(got, want, what, tree_leaves):
    """Phase m's check: two run records equal bit for bit."""
    diffs = [k for k in ("hist", "comm", "upload") if got[k] != want[k]]
    if not np.array_equal(got["gal_layers"], want["gal_layers"]):
        diffs.append("gal_layers")
    if not all(np.array_equal(a, b) for a, b in zip(got["orders"], want["orders"])):
        diffs.append("orders")
    for name, a, b in [("global_lora", got["global_lora"], want["global_lora"])] + [
            (f"stacked {k}", got["population"][k], want["population"].get(k)) for k in got["population"]]:
        la, lb = tree_leaves(a), tree_leaves(b) if b is not None else []
        if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
            diffs.append(name)
    if got["population"].keys() != want["population"].keys():
        diffs.append("stacked trees")
    if diffs:
        raise AssertionError(f"the sharded {what} differs from the vectorized run in {diffs}")


def phase_sharded(ops, make_runner, CompressionConfig, model, loss_fn, fl, clients, cfg, smi, refs, tree_clone,
                  tree_leaves):
    """Phase m: the sharded engine on a 1-rank NCCL group over this card,
    (i) phase 5's configuration and (ii) phase 6's compressed round, each
    held bit for bit to its vectorized run. Returns the launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_client_mesh

    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_client_mesh()
            with Launches(ops) as run:
                r = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw", fused_optimizer=True,
                                engine="sharded", mesh=mesh, seed=0)
                _, init_s = timed(r.init_phase)
                hist, secs = [], []
                for t in range(fl.rounds):
                    stats, sec = timed(lambda: r.run_round(t))
                    hist.append(stats)
                    secs.append(sec)
                    check_round(r, cfg, stats, t)
            steps = sum(int(h["padded_steps"]) for h in hist)
            log(f"sharded fibecfed (1 NCCL rank, {smi}): init_phase {init_s:.2f} s, rounds "
                f"{[round(x, 2) for x in secs]} s, {json.dumps(hist)}; launches {run.counts} over {steps} steps")
            if run.counts != only(masked_adamw_update=steps) or steps == 0:
                raise AssertionError("the sharded run did not launch the AdamW kernel once per step")
            check_same_run(run_record(r, hist, tree_clone), refs["vectorized"], "fibecfed run", tree_leaves)
            counts["masked_adamw_update_stacked"] = run.counts["masked_adamw_update"]
            del r
            comp = CompressionConfig(**COMPRESSION)
            with Launches(ops) as run:
                r = make_runner(PHASE6_BASELINE, model, loss_fn, fl, clients, optimizer="sgd", fused_optimizer=True,
                                engine="sharded", mesh=mesh, compression=comp, client_ranks=RANKS, seed=0)
                _, c_init_s = timed(r.init_phase)
                stats, c_sec = timed(lambda: r.run_round(0))
            check_round(r, cfg, stats, 0, comp, RANKS)
            steps = int(stats["padded_steps"])
            log(f"sharded compressed+ranks (1 NCCL rank, {smi}): init {c_init_s:.2f} s, round 0 {c_sec:.2f} s, "
                f"{json.dumps(stats)}; launches {run.counts}")
            if run.counts != only(masked_sgd_update=steps, fake_compress=1):
                raise AssertionError(f"the sharded compressed run did not go through its kernels: {run.counts}")
            check_same_run(run_record(r, [stats], tree_clone), refs["compressed"], "compressed round", tree_leaves)
            counts["masked_sgd_update_stacked"] = run.counts["masked_sgd_update"]
            counts["fake_compress"] = run.counts["fake_compress"]
            del r
        finally:
            dist.destroy_process_group()
    log("sharded runs equal to phases 5 and 6 bit for bit")
    return counts


def phase_runner_telemetry(make_runner, model, loss_fn, fl, clients, vec_round0, tree_leaves):
    """Phase 5e: phase 5's vectorized run again with ``telemetry=``: its
    decisions, round-0 stats, comm bytes and global LoRA equal phase 5's
    (``vec_round0``) bit for bit, and its trace is well formed."""
    from repro_torch.obs import Telemetry, check_spans

    tel = Telemetry(run_id="vectorized")
    vt = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw", fused_optimizer=True, seed=0,
                     telemetry=tel)
    vt.init_phase()
    stats = vt.run_round(0)
    stats0, comm0, lora0, gal_layers, orders = vec_round0
    same = (stats == stats0 and vt.comm_bytes_per_round == comm0[:1]
            and np.array_equal(vt.gal_layers, gal_layers)
            and all(np.array_equal(c.order, o) for c, o in zip(vt.clients, orders))
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(vt.global_lora), tree_leaves(lora0))))
    check_spans(tel.tracer.events)
    names = [e["name"] for e in tel.tracer.events if e["type"] == "span"]
    log(f"vectorized round 0 with telemetry: {json.dumps(stats)}; equal to phase 5's bit for bit: {same}; "
        f"spans {sorted(set(names))}; counters {tel.snapshot()['counters']}")
    if not same or names.count("round") != 1 or tel.snapshot()["counters"]["fl.rounds"] != 1:
        raise AssertionError("telemetry changed the vectorized round, or its trace is incomplete")


def phase_ssm(ops, ref, sparse_lora, ssd_chunk, make_runner, data_mod, FibecFedConfig, ARCHS, build_model,
              make_loss_fn):
    """Phase f: the Mamba2 family at full mamba2-1.3b width. The default
    vectorized FibecFed/AdamW (fused: stacked B1) trains on phase 4-5's
    keyword task over ``SSM_CLIENTS`` clients; then ``serve_phase`` serves
    phase 5d's requests on its global LoRA and three clients' adapters:
    prefill takes B9 for the intra-chunk scan (heads sharing b and c) and
    B7 for the per-slot LoRA of in_proj and out_proj, decode B7; every
    completion keeps its whole budget, and the served logits are held to
    the f32 training forward against the plain bf16 forward's own distance
    from it (``SSM_FLOOR_RATIO``). Then B9 against its plain version at
    every prefill group's shape, and timed at the 4x1024 group's. Returns
    the launch counts, the kernels' largest errors and the times."""
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.serve import Request, SamplingParams
    from repro_torch.utils.tree import tree_clone

    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["mamba2-1.3b"], num_layers=SSM_LAYERS)
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=SSM_CLIENTS, devices_per_round=SSM_CLIENTS, rounds=SSM_ROUNDS, batch_size=4)
    vec, train = train_vectorized("mamba2-1.3b", cfg, model, make_runner, make_loss_fn, fl,
                                  keyword_world(cfg.vocab_size, data_mod, fl), ops)
    params = vec.params
    adapters = [tree_clone(vec.global_lora)] + [tree_clone(vec.clients[i].lora) for i in range(3)]
    del vec
    torch.cuda.empty_cache()

    L = cfg.num_layers
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg), cache_len=SSM_CACHE,
                    launches=lambda st: only(ssd_chunk_intra=L * st["prefill_calls"],
                                             batched_sparse_lora_apply=2 * L * st["prefill_calls"],
                                             batched_sparse_lora_few_rows=2 * L * st["decode_steps"]),
                    oracle=dict(rel=SSM_FLOOR_RATIO, f32=True), b7_target="in_proj", label="mamba2 ")
    groups, times = s["groups"], dict(train=train, **s["times"])
    o = times["oracle"]
    log(f"mamba2 plain bf16 forward against the f32 one at the served positions (the floor): {o['floor']:.4f} of "
        f"a row's largest |logit|; the served path held within {SSM_FLOOR_RATIO}x it")
    log_oracle("mamba2 ", o, f"the f32 forward, within {SSM_FLOOR_RATIO}x the bf16 forward's floor")
    for (S, budget, _), c in zip(SERVE_REQUESTS, s["comps"]):  # no clamp to the cache: its size is constant
        if c.prompt_len != S or c.finish_reason != "length" or c.steps != budget:
            raise AssertionError(f"mamba2 serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    log(f"mamba2 serve times: {json.dumps({k: v for k, v in times.items() if not k.startswith('b7')})}")

    # B9 at each prefill group's shape (heads sharing b and c) against its
    # plain version, and timed at the 4x1024 group's
    nh = ssm_dims(cfg)["nheads"]
    gen, errs = s["gen"], {}
    for g, S in sorted(set(groups)):
        x, a, b, c = ssd_inputs(gen, torch.bfloat16, B=g, S=S, heads=nh)
        errs[f"{g}x{S}"] = check_ssd(ops.ssd_chunk_intra(x, a, b, c, heads=nh), ref.ssd_chunk_intra_ref(x, a, b, c, nh),
                                     ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs(), nh), a,
                                     f"B9 serve prefill {g}x{S}")
    log(f"mamba2 B9 and B7 vs plain at the serve shapes: within tolerance; max abs err "
        f"{json.dumps({**{f'B9 {k}': e for k, e in errs.items()}, **s['errs']})}")
    x, a, b, c = ssd_inputs(gen, torch.bfloat16, B=4, S=1024, heads=nh)
    y = torch.empty(x.shape, dtype=torch.float32, device="cuda")
    launch = lambda _=0: ssd_chunk.ssd_chunk_launch(y, x, a, b, c, nh)  # noqa: E731
    b9 = dict(groups=x.shape[0], heads=nh, max_abs_err=max(errs.values()),
              ms=cuda_ms(launch), graph_ms=graph_ms(launch, calls=5, replays=3),
              wrapper_ms=cuda_ms(lambda: ops.ssd_chunk_intra(x, a, b, c, heads=nh)),
              plain_ms=cuda_ms(lambda: ref.ssd_chunk_intra_ref(x, a, b, c, nh), iters=5, warmup=1),
              library_ms=None, **ssd_bound(x, a, b, nh))
    b9["bound_share"] = b9["bound_ms"] / b9["graph_ms"]
    log(f"mamba2 serve shape B9 prefill 4x1024 ({b9['groups']} groups, heads {nh}): device {b9['graph_ms']:.4f} ms, "
        f"{b9['bound_share']:.1%} of its bound ({b9['bound_ms']:.5f} ms, {b9['bound_by']}); launcher "
        f"{b9['ms']:.4f}, wrapper {b9['wrapper_ms']:.4f}, plain {b9['plain_ms']:.4f}")
    times["b9_prefill"] = b9
    log(f"phase f: {time.perf_counter() - t0:.1f} s")
    counts = {n: s["counts"][n] for n in ("ssd_chunk_intra", "batched_sparse_lora_apply",
                                          "batched_sparse_lora_few_rows", "batched_sparse_lora_split")}
    counts["masked_adamw_update_stacked"] = train["padded_steps"]
    return counts, {"ssd_chunk_intra": max(errs.values()), "batched_sparse_lora_apply": s["b7_err"],
                    "batched_sparse_lora_few_rows": s["few_err"], "batched_sparse_lora_split": s["split_err"]}, times


def dense_adapters(model, gen):
    """Four seeded adapters of a model that trains none here: a as
    ``init_lora`` draws it, b from N(0, DENSE_B_SCALE²) (an all-zero b would
    leave the LoRA out, and the oracle's first control would read 0)."""
    adapters = []
    for _ in range(4):
        lora = model.init_lora(gen, "cuda")
        for targets in lora.values():
            for ab in targets.values():
                ab["b"].normal_(0.0, DENSE_B_SCALE, generator=gen)
        adapters.append(lora)
    return adapters


def phase_dense_family(ops, ref, sparse_lora, flash_attention, make_runner, data_mod, FibecFedConfig, ARCHS,
                       build_model, make_loss_fn, FedPrompt):
    """Phase h: the rest of the dense family at full width, bf16
    from a seeded torch init.
    (i) qwen3-0.6b at QWEN3_LAYERS layers: the default vectorized FibecFed/AdamW for 2 rounds on
    phase 4-5's keyword task (8 clients, cohort 4, batch 4), then
    ``serve_phase`` with phase 5d's 12 requests on its global LoRA and
    three clients' adapters (B8 behind qk-norm at D 128; B7 SGMV on
    prefill, the few-row path on decode).
    (ii) stablelm-3b (parallel residual, LayerNorm, D 80: B8 at D 80) and
    chatglm3-6b (2 KV heads, QKV bias, half RoPE), serving only: 4 requests
    each (prompts of 128 and 1024 tokens, budgets 16) over 4 seeded
    adapters; each model freed before the next is built.
    Every served logit is held to its training forward by phase 5d's
    oracle (0.05 of a row's largest |logit|), with both controls above 1;
    B8 against its plain version at every prefill group's shape.
    (iii) FedPrompt on full qwen2-0.5b: 1 round (cohort 4, 16 prompt
    vectors), ``evaluate``, the exact comm bytes, and the prefixed forward's
    last logits held to the same forward in f32 at phase 5d's tolerance.
    Returns the launch counts, the largest errors and the times."""
    from repro_torch.serve import Request, SamplingParams
    from repro_torch.utils.tree import tree_clone, tree_map

    t_phase = time.perf_counter()
    counts = dict.fromkeys(("masked_adamw_update_stacked", "flash_attention", "flash_attention_d80",
                            *B7_KERNELS), 0)
    errs = dict.fromkeys(("flash_attention", "flash_attention_d80", *B7_KERNELS), 0.0)
    times = {}

    def served(name, s, b8_key, b8_errs, n):
        counts[b8_key] += s["counts"]["flash_attention"]
        errs[b8_key] = max(errs[b8_key], max(b8_errs.values()))
        add_b7(counts, errs, s)
        log_oracle(f"{name} ", s["times"]["oracle"], "the bf16 forward")
        prof = s["times"]["profiles"]["decode"]
        log(f"{name} ({n} layers): decode step {s['times']['decode_step_ms']:.2f} ms, busy {prof['busy_share']:.1%}, "
            f"B7 {prof['b7_share']:.1%} of its {prof['kernel_ms']:.2f} ms of kernels; useful tokens/s "
            f"{s['times']['useful_tokens_per_s']:.1f}; TTFT mean {s['times']['ttft_mean_ms']:.1f} ms")
        (key, prof), = [(k, p) for k, p in s["times"]["profiles"].items() if k.startswith("prefill")]
        log(f"{name} {key}: B7 {prof['b7_share']:.1%} of its {prof['kernel_ms']:.2f} ms of kernels (path "
            f"{s['times']['b7_prefill']['path']}), busy {prof['busy_share']:.1%}")

    # (i) qwen3-0.6b: train, then serve
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"], num_layers=QWEN3_LAYERS)
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=2, batch_size=4)
    vec, train = train_vectorized("qwen3-0.6b", cfg, model, make_runner, make_loss_fn, fl,
                                  keyword_world(cfg.vocab_size, data_mod, fl), ops)
    counts["masked_adamw_update_stacked"] += train["padded_steps"]
    adapters = [tree_clone(vec.global_lora)] + [tree_clone(vec.clients[i].lora) for i in range(3)]
    params = vec.params
    times["qwen3-0.6b"] = dict(train=train)
    del vec
    torch.cuda.empty_cache()
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg), cache_len=SERVE_CACHE,
                    launches=dense_serve_launches(cfg.num_layers), oracle=dict(rel=SERVE_LOGIT_REL),
                    b7_target="wq", label="qwen3-0.6b ")
    for (S, budget, _), c in zip(SERVE_REQUESTS, s["comps"]):
        if c.prompt_len != S or c.finish_reason != "length" or c.steps != min(budget, SERVE_CACHE - S):
            raise AssertionError(f"qwen3 serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], "qwen3-0.6b ")
    served("qwen3-0.6b", s, "flash_attention", b8_errs, cfg.num_layers)
    times["qwen3-0.6b"].update(s["times"], b8_prefill=b8, seconds=time.perf_counter() - t0)
    del params, adapters, s, model
    torch.cuda.empty_cache()

    # (ii) stablelm-3b and chatglm3-6b: serving only, seeded adapters
    for name in ("stablelm-3b", "chatglm3-6b"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], num_layers=DENSE_SERVE_LAYERS)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(21)
        params = model.init_params(gen, "cuda")
        adapters = dense_adapters(model, gen)
        s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                        lambda: serve_requests(Request, SamplingParams, cfg, spec=DENSE_REQUESTS),
                        cache_len=SERVE_CACHE, launches=dense_serve_launches(cfg.num_layers),
                        oracle=dict(rel=SERVE_LOGIT_REL), b7_target="wq", label=f"{name} ")
        for (S, budget, _), c in zip(DENSE_REQUESTS, s["comps"]):
            if c.prompt_len != S or c.finish_reason != "length" or c.steps != budget:
                raise AssertionError(f"{name} serve request {c.request_id}: {c.steps} tokens for budget {budget}")
        b8_key = "flash_attention_d80" if cfg.resolved_head_dim == 80 else "flash_attention"
        b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], f"{name} ")
        served(name, s, b8_key, b8_errs, cfg.num_layers)
        times[name] = dict(s["times"], b8_prefill=b8, seconds=time.perf_counter() - t0)
        del params, adapters, s, model
        torch.cuda.empty_cache()

    # (iii) FedPrompt on full qwen2-0.5b
    t0 = time.perf_counter()
    cfg = ARCHS["qwen2-0.5b"]
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=1, batch_size=4)
    clients = keyword_world(cfg.vocab_size, data_mod, fl)
    test = data_mod.make_keyword_task(n_samples=64, seq_len=64, vocab_size=cfg.vocab_size, seed=1).data
    test = {k: v for k, v in test.items() if k != "label"}
    with Launches(ops) as run:
        fp = FedPrompt(model, fl, clients, n_prompt=PROMPT_VECTORS, seed=0)
        stats, round_s = timed(lambda: fp.run_round(0))
        acc, eval_s = timed(lambda: fp.evaluate(test, batch_size=32))
    want_bytes = 2 * fl.devices_per_round * PROMPT_VECTORS * cfg.d_model * 4
    log(f"FedPrompt (qwen2-0.5b, cohort {fl.devices_per_round}, {PROMPT_VECTORS} prompt vectors): round 0 "
        f"{round_s:.2f} s, loss {stats['loss']:.6f}; comm bytes {fp.comm_bytes_per_round} (2·4·16·896·4 = "
        f"{want_bytes}); evaluate accuracy {acc:.4f} on {len(test['tokens'])} samples ({eval_s:.2f} s); "
        f"launches {run.counts}")
    if fp.comm_bytes_per_round != [want_bytes] or not isinstance(fp.comm_bytes_per_round[0], int) \
            or not math.isfinite(stats["loss"]) or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"FedPrompt: comm bytes {fp.comm_bytes_per_round}, loss {stats['loss']}, acc {acc}")
    if any(run.counts.values()):
        raise AssertionError(f"FedPrompt launched a kernel (its forward is plain, as in JAX): {run.counts}")
    # the prefixed forward (bf16) against the same forward in f32, params widened
    batch = {k: torch.as_tensor(v[:4], device="cuda").long() for k, v in test.items()}
    prefix = fp.prompt[None].expand(4, *fp.prompt.shape)
    with torch.no_grad():
        got, _ = model.forward(fp.params, fp.lora, {**batch, "prefix_embeds": prefix.bfloat16()})
        want, _ = model.forward(tree_map(lambda x: x.float(), fp.params), fp.lora, {**batch, "prefix_embeds": prefix})
    got, want = got[:, -1].float(), want[:, -1].float()
    if got.shape != (4, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"FedPrompt prefixed logits: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    rel = float(((got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max())
    log(f"FedPrompt prefixed forward (bf16) vs f32 at the last position: {rel:.4f} of a row's largest |logit| "
        f"(tolerance {SERVE_LOGIT_REL}: {rel / SERVE_LOGIT_REL:.3f} of it)")
    if rel > SERVE_LOGIT_REL:
        raise AssertionError("FedPrompt's prefixed bf16 forward is beyond the tolerance from its f32 forward")
    times["fedprompt"] = dict(round_s=round_s, loss=stats["loss"], comm_bytes=fp.comm_bytes_per_round[0],
                              accuracy=acc, eval_s=eval_s, f32_rel=rel, seconds=time.perf_counter() - t0)
    del fp, model
    torch.cuda.empty_cache()
    log(f"phase h: {time.perf_counter() - t_phase:.1f} s")
    return counts, errs, times


@contextlib.contextmanager
def plain_kernels(ops, ref):
    """B7 and B8 swapped for their plain versions on the card for the
    duration: the model reaches both through ``repro_torch.kernels.ops``'s
    attributes. The plain versions launch no kernel and count nothing."""
    saved = ops.batched_sparse_lora_apply, ops.flash_attention

    def b7(x, idx, a, b, mask, scale=1.0):
        K, N = x.shape[-1], b.shape[-1]
        y = ref.batched_sparse_lora_matmul_ref(x.reshape(-1, K), idx.reshape(-1), a, b, mask, scale)
        return y.reshape(*x.shape[:-1], N)

    def b8(q, k, v, *, causal=True, window=None):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)

    ops.batched_sparse_lora_apply, ops.flash_attention = b7, b8
    try:
        yield
    finally:
        ops.batched_sparse_lora_apply, ops.flash_attention = saved


@contextlib.contextmanager
def routing_log(moe_mod):
    """Every MoE routing's kept (token, expert) assignments, (..., G, E)
    bools, in call order, while the block runs."""
    calls, route = [], moe_mod.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        calls.append(out[0].sum(dim=-1) > 0)
        return out

    moe_mod.route = recorded
    try:
        yield calls
    finally:
        moe_mod.route = route


def moe_recorder(ops, ref, moe_mod, rel):
    """Phase i's MoE oracle as a ``serve_phase`` recorder: a ServeEngine
    whose model checks each prefill group and each decode step as it serves
    them (the MoE oracle at ``MOE_LOGIT_REL``): prefill's last logits against
    the training forward over the group's prompts with the group's per-slot
    adapters, a decode step against the same step teacher-forced on a copy
    of its cache, both with B7 and B8 plain (``plain_kernels``); each also
    with the LoRA left out and with the next adapter (the controls). It
    counts the (token, expert) assignments that differ between the served
    and the oracle run. Returns ``(make, record, groups)``; ``record`` goes
    to :func:`moe_oracle`."""

    def make_recorder(ServeEngine, model):
        from repro_torch.lora import gather_adapter_slots
        from repro_torch.utils.tree import tree_clone

        record = dict(rows=[], assign={"prefill": [0, 0], "decode": [0, 0]})
        groups, holder = [], {}

        def err(x, want):
            return float((x.float() - want.float()).abs().max() / want.float().abs().max())

        def note(kind, req, got, want, off, nxt):
            got, want = got.float(), want.float()
            top2 = want.topk(2).values
            tol = rel * float(want.abs().max())
            record["rows"].append(dict(
                kind=kind, request=req.request_id, greedy=req.sampling.temperature == 0.0, err=err(got, want),
                off=err(got, off), next=err(got, nxt), flip=int(got.argmax()) != int(want.argmax()),
                gap=float(want.max() - want[got.argmax()]), tie=float(top2[0] - top2[1]) <= tol, tol=tol))

        def count(kind, served, plain, rows=None):
            if len(served) != len(plain):
                raise AssertionError(f"MoE oracle: {len(served)} served routings against {len(plain)}")
            for a, b in zip(served, plain):
                if rows is not None:  # a decode step routes its B rows as one group: (1, 1, B, E)
                    a, b = a[..., rows, :], b[..., rows, :]
                record["assign"][kind][0] += int((a != b).sum())
                record["assign"][kind][1] += int(a.sum())

        def next_lora(eng, ids):
            return gather_adapter_slots(model.cfg, eng._stacked, (ids + 1) % len(eng.adapters))

        def prefill(params, lora, batch, cache_len):
            eng, reqs = holder["engine"], holder["group"]
            with routing_log(moe_mod) as served:
                out, cache, S = model.prefill(params, lora, batch, cache_len)
            ids = torch.tensor([r.adapter_id for r in reqs], dtype=torch.int64, device=out.device)
            with torch.no_grad(), plain_kernels(ops, ref):
                with routing_log(moe_mod) as plain:
                    want = model.forward(params, lora, batch)[0][:, -1]
                off = model.forward(params, lora_left_out(lora), batch)[0][:, -1]
                nxt = model.forward(params, next_lora(eng, ids), batch)[0][:, -1]
            count("prefill", served, plain)
            for row, r in enumerate(reqs):
                note("prefill", r, out[row, -1], want[row], off[row], nxt[row])
            return out, cache, S

        def decode_step(params, lora, token, cache, position):
            eng = holder["engine"]
            busy = sorted(eng.scheduler._busy.items())
            rows = torch.tensor([slot for slot, _ in busy], dtype=torch.int64, device=token.device)
            with torch.no_grad(), plain_kernels(ops, ref):
                with routing_log(moe_mod) as plain:
                    want = model.decode_step(params, lora, token, tree_clone(cache), position)[0][:, -1]
                off = model.decode_step(params, lora_left_out(lora), token, tree_clone(cache), position)[0][:, -1]
                nxt = model.decode_step(params, next_lora(eng, eng._state["aidx"]), token, tree_clone(cache),
                                        position)[0][:, -1]
            with routing_log(moe_mod) as served:
                out, cache = model.decode_step(params, lora, token, cache, position)
            count("decode", served, plain, rows)
            for slot, r in busy:
                note("decode", r, out[slot, -1], want[slot], off[slot], nxt[slot])
            return out, cache

        class Recording(ServeEngine):
            def _admit_group_body(self, slots, reqs):
                holder["group"] = reqs
                groups.append((len(reqs), len(reqs[0].tokens)))
                super()._admit_group_body(slots, reqs)

        def make(*args, **kw):
            eng = Recording(dataclasses.replace(model, prefill=prefill, decode_step=decode_step), *args, **kw)
            holder["engine"] = eng
            return eng

        return make, record, groups

    return make_recorder


def moe_oracle(rel):
    """Sums up a :func:`moe_recorder` run in ``serve_oracle``'s keys (errors
    and controls as shares of the tolerance, the prefill rows apart from
    the decode steps), with the differing (token, expert) assignments;
    raises where a row is beyond the tolerance, a greedy token is off the
    oracle's argmax beyond a near-tie, or a control reads at most 1."""

    def summary(reqs, comps, record):
        rows = record["rows"]
        if not rows or not all(math.isfinite(r["err"]) for r in rows):
            raise AssertionError("MoE oracle: no rows, or a non-finite logit")
        out = dict(positions=len(rows), worst=max(r["err"] for r in rows) / rel, tolerance=rel,
                   worst_prefill=max((r["err"] for r in rows if r["kind"] == "prefill"), default=0.0) / rel,
                   worst_decode=max((r["err"] for r in rows if r["kind"] == "decode"), default=0.0) / rel,
                   flips=sum(r["flip"] for r in rows if r["greedy"]), ties=sum(r["tie"] for r in rows if r["greedy"]),
                   assignments={k: dict(differ=d, kept=n) for k, (d, n) in record["assign"].items()})
        if out["worst"] > 1.0:
            raise AssertionError(f"MoE oracle: logits {out['worst']:.3f}x the tolerance from the oracle run")
        if any(r["greedy"] and r["flip"] and r["gap"] > r["tol"] for r in rows):
            raise AssertionError("MoE oracle: a greedy token is no near-tie of the oracle's")
        per_req = {}
        for r in rows:
            e = per_req.setdefault(r["request"], [0.0, 0.0])
            e[0], e[1] = max(e[0], r["off"] / rel), max(e[1], r["next"] / rel)
        out.update(control_lora_off=min(v[0] for v in per_req.values()),
                   control_next_adapter=min(v[1] for v in per_req.values()), requests=len(per_req))
        if len(per_req) != len(reqs):
            raise AssertionError(f"MoE oracle: {len(per_req)} requests checked of {len(reqs)}")
        return out

    return summary


def train_vectorized(name, cfg, model, make_runner, make_loss_fn, fl, clients, ops):
    """The default vectorized FibecFed/AdamW (fused: stacked B1) for
    ``fl.rounds`` rounds: the engine's vmap over the cohort must find a
    batching rule for every op (a fallback to a loop over the clients
    warns), each step launch B1 once and each round move exactly the
    recomputed comm bytes. Returns the runner and its times."""
    import warnings

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with Launches(ops) as run, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vec = make_runner("fibecfed", model, make_loss_fn(model), fl, clients, optimizer="adamw",
                              fused_optimizer=True, seed=0)
            if vec.engine != "vectorized" or fl.gal_fraction is None or fl.sparse_ratio is None:
                raise AssertionError(f"{name} trains on the default engine with pinned fractions")
            _, init_s = timed(vec.init_phase)
            steps, round_s = 0, []
            for t in range(fl.rounds):
                stats, secs = timed(lambda: vec.run_round(t))
                steps += int(stats["padded_steps"])
                round_s.append(secs)
                log(f"{name} vectorized fibecfed round {t}: {secs:.2f} s, {json.dumps(stats)}")
                check_round(vec, cfg, stats, t)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = [str(w.message) for w in caught if "batching rule" in str(w.message)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} vectorized fibecfed ({fl.num_devices} clients, cohort {fl.devices_per_round}): init_phase "
        f"{init_s:.2f} s, gal layers {np.flatnonzero(vec.gal_layers).tolist()} of {len(vec.gal_layers)}; peak "
        f"{peak:.2f} GiB; launches {run.counts} over {steps} padded steps; vmap fallbacks {len(fallbacks)} "
        f"{fallbacks[:2]}")
    if run.counts != only(masked_adamw_update=steps) or steps == 0:
        raise AssertionError(f"the {name} vectorized run did not launch the AdamW kernel once per step")
    if fallbacks:
        raise AssertionError(f"the {name} stacked engine fell back to a loop over the clients")
    return vec, dict(init_s=init_s, round_s=round_s, padded_steps=steps, peak_gib=peak,
                     gal_layers=np.flatnonzero(vec.gal_layers).tolist(), clients=fl.num_devices,
                     cohort=fl.devices_per_round, layers=cfg.num_layers)


def phase_moe_hybrid(ops, ref, sparse_lora, flash_attention, ssd_chunk, make_runner, data_mod, FibecFedConfig,
                     ARCHS, build_model, make_loss_fn):
    """Phase i: the MoE family and the zamba2 hybrid at full width, bf16 from
    a seeded torch init.
    (i) granite-moe-3b-a800m (32 layers, 40 experts top-8, 24/8 heads of 64):
    the default vectorized FibecFed/AdamW for 2 rounds on phase 4-5's keyword
    task (8 clients, cohort 4, batch 4), then ``serve_phase`` with phase 5d's
    12 requests (one EOS stop, one sampled) on its global LoRA and three
    clients' adapters: B8 (D 64) on prefill, B7 on the attention LoRA
    (SGMV on prefill, the few-row path on decode), held by the MoE oracle.
    (ii) llama4-maverick-400b-a17b at full width, cut to LLAMA4_LAYERS
    layer (128 experts top-1 and a shared expert): 4 requests over 4
    seeded adapters, B8 at D 128, the MoE oracle.
    (iii) zamba2-7b at full width, ZAMBA2_SERVE_LAYERS layers: phase 5d's 12 requests over 4
    seeded adapters: B9 (112 heads sharing b and c, state 64) on every
    Mamba layer's prefill scan, B8 at D 112 on each application of the
    shared block, B7 on in_proj/out_proj and the shared block's attention
    (the few-row path on decode); phase f's oracle against the f32 forward.
    (iv) zamba2-7b's width cut to ZAMBA2_TRAIN_LAYERS layers (two
    applications of the shared block): the vectorized FibecFed/AdamW, cohort
    4 of ZAMBA2_CLIENTS clients, 1 round: B1 over a tree with the shared
    block's unstacked group.
    B7, B8 and B9 are held against their plain versions at every shape the
    served paths gave them. Returns the launch counts, the largest errors
    and the times."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.serve import Request, SamplingParams, ServeEngine
    from repro_torch.utils.tree import tree_clone, tree_leaves

    free_memory()
    t_phase = time.perf_counter()
    counts = dict.fromkeys(("masked_adamw_update_stacked", "flash_attention", "flash_attention_d112",
                            *B7_KERNELS, "ssd_chunk_intra"), 0)
    errs = dict.fromkeys(("flash_attention", "flash_attention_d112", *B7_KERNELS, "ssd_chunk_intra"), 0.0)
    times = {}

    def served(name, s, b8_key, b8_errs):
        add_b7(counts, errs, s)
        counts[b8_key] += s["counts"]["flash_attention"]
        errs[b8_key] = max(errs[b8_key], max(b8_errs.values()))
        prof = s["times"]["profiles"]["decode"]
        log(f"{name}: decode step {s['times']['decode_step_ms']:.2f} ms, busy {prof['busy_share']:.1%}, B7 "
            f"{prof['b7_share']:.1%} of its {prof['kernel_ms']:.2f} ms of kernels; useful tokens/s "
            f"{s['times']['useful_tokens_per_s']:.1f}; TTFT mean {s['times']['ttft_mean_ms']:.1f} ms; serve peak "
            f"{s['times']['serve_peak_gib']:.2f} GiB; B7 path by shape {json.dumps(s['paths'])}")

    def moe_served(name, o):
        log_oracle(f"{name} ", o, f"the same network with B7/B8 plain, batched as served, within {MOE_LOGIT_REL}")
        a = o["assignments"]
        log(f"{name} (token, expert) assignments differing from the oracle run: prefill {a['prefill']['differ']} "
            f"of {a['prefill']['kept']} kept, decode {a['decode']['differ']} of {a['decode']['kept']}")

    moe_kw = dict(oracle=moe_oracle(MOE_LOGIT_REL), recorder=moe_recorder(ops, ref, moe_mod, MOE_LOGIT_REL))

    # (i) granite-moe-3b-a800m: train, then serve
    t0 = time.perf_counter()
    cfg = ARCHS["granite-moe-3b-a800m"]
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=2, batch_size=4)
    vec, train = train_vectorized("granite-moe-3b-a800m", cfg, model, make_runner, make_loss_fn, fl,
                                  keyword_world(cfg.vocab_size, data_mod, fl), ops)
    counts["masked_adamw_update_stacked"] += train["padded_steps"]
    params = vec.params
    adapters = [tree_clone(vec.global_lora)] + [tree_clone(vec.clients[i].lora) for i in range(3)]
    del vec
    free_memory()
    eos, stop, probe = eos_from_probe(ServeEngine, model, params, adapters,
                                      serve_requests(Request, SamplingParams, cfg), SERVE_CACHE)
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg, eos), cache_len=SERVE_CACHE,
                    launches=dense_serve_launches(cfg.num_layers), b7_target="wq", label="granite ", **moe_kw)
    for (S, budget, _), c in zip(SERVE_REQUESTS, s["comps"]):
        if c.prompt_len != S or (c.finish_reason == "length" and c.steps != min(budget, SERVE_CACHE - S)):
            raise AssertionError(f"granite serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    ce = s["comps"][SERVE_EOS]
    if ce.finish_reason != "eos" or not np.array_equal(ce.tokens, stop):
        raise AssertionError(f"granite: the EOS request did not stop at its first {eos} ({ce.tokens} vs {stop})")
    moe_served("granite", s["times"]["oracle"])
    b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], "granite ")
    served("granite-moe-3b-a800m", s, "flash_attention", b8_errs)
    times["granite-moe-3b-a800m"] = dict(s["times"], train=train, b8_prefill=b8, seconds=time.perf_counter() - t0)
    del params, adapters, s, model, probe
    free_memory()

    # (ii) llama4-maverick-400b-a17b, full width, depth cut: serving only
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"], num_layers=LLAMA4_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(22)
    params = model.init_params(gen, "cuda")
    adapters = dense_adapters(model, gen)
    log(f"llama4 ({cfg.num_layers} layer): {sum(x.numel() for x in tree_leaves(params)) / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg, spec=DENSE_REQUESTS), cache_len=SERVE_CACHE,
                    launches=dense_serve_launches(cfg.num_layers), b7_target="wq", label="llama4 ", **moe_kw)
    for (S, budget, _), c in zip(DENSE_REQUESTS, s["comps"]):
        if c.prompt_len != S or c.finish_reason != "length" or c.steps != budget:
            raise AssertionError(f"llama4 serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    moe_served("llama4", s["times"]["oracle"])
    b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], "llama4 ")
    served("llama4-maverick-400b-a17b", s, "flash_attention", b8_errs)
    times["llama4-maverick-400b-a17b"] = dict(s["times"], b8_prefill=b8, layers=cfg.num_layers,
                                              seconds=time.perf_counter() - t0)
    del params, adapters, s, model
    free_memory()

    # (iii) zamba2-7b at full width, its depth cut: serving
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["zamba2-7b"], num_layers=ZAMBA2_SERVE_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(23)
    params = model.init_params(gen, "cuda")
    adapters = dense_adapters(model, gen)
    L, n_apps = cfg.num_layers, cfg.num_layers // cfg.hybrid_period
    b7_calls = 2 * L + 4 * n_apps  # in_proj and out_proj of every Mamba layer; wq-wo of every application
    log(f"zamba2-7b: {sum(x.numel() for x in tree_leaves(params)) / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; {n_apps} applications of the shared block")
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg), cache_len=SERVE_CACHE,
                    launches=lambda st: only(ssd_chunk_intra=L * st["prefill_calls"],
                                             flash_attention=n_apps * st["prefill_calls"],
                                             batched_sparse_lora_apply=b7_calls * st["prefill_calls"],
                                             batched_sparse_lora_few_rows=b7_calls * st["decode_steps"]),
                    oracle=dict(rel=HYBRID_FLOOR_RATIO, f32=True), b7_target="mamba/in_proj", label="zamba2 ")
    o = s["times"]["oracle"]
    log(f"zamba2 plain bf16 forward against the f32 one at the served positions (the floor): {o['floor']:.4f} of "
        f"a row's largest |logit|; the served path held within {HYBRID_FLOOR_RATIO}x it")
    log_oracle("zamba2 ", o, f"the f32 forward, within {HYBRID_FLOOR_RATIO}x the bf16 forward's floor")
    for (S, budget, _), c in zip(SERVE_REQUESTS, s["comps"]):
        if c.prompt_len != S or c.finish_reason != "length" or c.steps != min(budget, SERVE_CACHE - S):
            raise AssertionError(f"zamba2 serve request {c.request_id}: {c.steps} tokens for budget {budget}")
    b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], "zamba2 ")
    served("zamba2-7b", s, "flash_attention_d112", b8_errs)
    counts["ssd_chunk_intra"] += s["counts"]["ssd_chunk_intra"]
    nh, gen = ssm_dims(cfg)["nheads"], s["gen"]
    b9_errs = {}
    for g, S in sorted(set(s["groups"])):
        x, a, b, c = ssd_inputs(gen, torch.bfloat16, B=g, S=S, heads=nh, widths=ZAMBA2_SSD)
        b9_errs[f"{g}x{S}"] = check_ssd(ops.ssd_chunk_intra(x, a, b, c, heads=nh),
                                        ref.ssd_chunk_intra_ref(x, a, b, c, nh),
                                        ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs(), nh), a,
                                        f"zamba2 B9 serve prefill {g}x{S}")
    errs["ssd_chunk_intra"] = max(errs["ssd_chunk_intra"], max(b9_errs.values()))
    log(f"zamba2 B9 (heads {nh}, state {cfg.ssm.d_state}) and B7 vs plain at the serve shapes: within tolerance; "
        f"max abs err {json.dumps({**{f'B9 {k}': e for k, e in b9_errs.items()}, **s['errs']})}")
    times["zamba2-7b"] = dict(s["times"], b8_prefill=b8, seconds=time.perf_counter() - t0)
    del params, adapters, s, model
    free_memory()

    # (iv) zamba2-7b's width, depth cut: training over the unstacked group
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["zamba2-7b"], num_layers=ZAMBA2_TRAIN_LAYERS)
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=ZAMBA2_CLIENTS, devices_per_round=4, rounds=1, batch_size=4)
    vec, train = train_vectorized(f"zamba2-7b ({cfg.num_layers} layers)", cfg, model, make_runner, make_loss_fn,
                                  fl, keyword_world(cfg.vocab_size, data_mod, fl), ops)
    counts["masked_adamw_update_stacked"] += train["padded_steps"]
    shared = {t: ab["b"].shape for t, ab in vec.global_lora["shared"].items()}
    log(f"zamba2 training: LoRA groups {sorted(vec.global_lora)}, the shared block's unstacked b {shared}; "
        f"GAL layers {train['gal_layers']} (the shared block is logical layer {cfg.num_layers})")
    times["zamba2-7b_train"] = dict(train, seconds=time.perf_counter() - t0)
    del vec, model
    free_memory()
    log(f"phase i: {time.perf_counter() - t_phase:.1f} s")
    return counts, errs, times


def family_world(cfg, data_mod, fl, n_samples):
    """``n_samples`` samples of the keyword task (64 tokens) over
    ``fl.num_devices`` clients, with the family's inputs: seeded N(0, 1)
    frame (encoder-decoder) or patch (vlm) embeddings as f32 numpy (the
    runner casts them to the model's dtype), or, for the encoder, the
    task's label mod ``num_classes`` as ``labels`` in place of the label
    token."""
    task = data_mod.make_keyword_task(n_samples=n_samples, seq_len=64, vocab_size=cfg.vocab_size, seed=0)
    data = {"tokens": task.data["tokens"], "label_token": task.data["label_token"]}
    rng = np.random.default_rng(3)
    if cfg.family in ("audio", "encdec"):
        data["encoder_embeds"] = rng.standard_normal((n_samples, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        data["prefix_embeds"] = rng.standard_normal((n_samples, cfg.num_prefix_embeddings, cfg.d_model),
                                                    dtype=np.float32)
    if cfg.family == "encoder":
        data = {"tokens": task.data["tokens"], "labels": (task.data["label"] % cfg.num_classes).astype(np.int32)}
    parts = data_mod.dirichlet_partition(task.data["label"], fl.num_devices, fl.dirichlet_alpha, seed=0)
    return [{k: v[i] for k, v in data.items()} for i in parts]


def eos_from_probe(ServeEngine, model, params, adapters, reqs, cache_len):
    """Phase 5d's EOS: serve ``reqs`` once; the EOS request's stop token is
    one that first appears at index 3 or later of its greedy stream (else
    the latest first appearance), so the stream stops mid-way at it.
    Returns the token, the stream up to it and the probe's completions."""
    probe = serve_all(ServeEngine(model, params, adapters[0], adapters=adapters[1:], cache_len=cache_len,
                                  num_slots=SERVE_SLOTS, max_new_cap=max(r.sampling.max_new_tokens for r in reqs)),
                      reqs)
    free = probe[SERVE_EOS].tokens
    firsts = [j for j in range(len(free)) if free[j] not in free[:j]]
    k = next((j for j in firsts if j >= 3), firsts[-1])
    return int(free[k]), free[:k + 1], probe


def phase_last_families(ops, ref, sparse_lora, flash_attention, make_runner, data_mod, FibecFedConfig, ARCHS,
                        build_model, make_loss_fn):
    """Phase j: the encoder-decoder, vlm and encoder families at full width,
    bf16 from a seeded torch init.
    (i) whisper-large-v3 (WHISPER_SERVE_LAYERS encoder + decoder layers, 20 heads of 64,
    1500 frames): ``serve_phase`` with phase 5d's 12 requests, each with its
    own frame embeddings, over 4 seeded adapters, cache 1152, one EOS stop,
    one sampled: on prefill B8 bidirectional over the encoder and causal
    over the prompt, B7 on the encoder's and the decoder's LoRA (cwk/cwv
    over the encoder's output); on decode B7's few-row path (self- and
    cross-attention's wq/wo). Phase 5d's oracle with a third control (the
    next request's frames). B8 (both masks) and B7 (at the encoder's row
    counts too) against their plain versions at the served shapes.
    (ii) its width cut to WHISPER_TRAIN_LAYERS + WHISPER_TRAIN_LAYERS
    layers: the vectorized FibecFed/AdamW (stacked B1), cohort 4 of 8, 1
    round; its GAL layers over the 8 logical layers.
    (iii) paligemma-3b (18 layers, 8 heads of 256 over 1 KV head, 256 prefix
    rows): as (i) with patch embeddings and a PALIGEMMA_CACHE-token cache:
    B8 at D 256 and B7 on prefill, the few-row path on decode.
    (iv) its width cut to PALIGEMMA_TRAIN_LAYERS layers trained as (ii).
    (v) roberta-large at full width and depth: the vectorized FibecFed/AdamW for
    ROBERTA_ROUNDS rounds on the keyword task relabelled to 2 classes over 8
    clients, cohort 4; its Fisher difficulty scores held to the loop
    engine's; ``evaluate``'s class accuracy on held-out samples.
    Returns the launch counts, the largest errors and the times."""
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    free_memory()
    t_phase = time.perf_counter()
    counts = dict.fromkeys(("masked_adamw_update_stacked", "flash_attention", "flash_attention_d256",
                            *B7_KERNELS), 0)
    errs = dict.fromkeys(("flash_attention", "flash_attention_d256", *B7_KERNELS), 0.0)
    times = {}

    def served(name, s, b8_key, b8_errs):
        add_b7(counts, errs, s)
        counts[b8_key] += s["counts"]["flash_attention"]
        errs[b8_key] = max(errs[b8_key], max(b8_errs.values()))
        log_oracle(f"{name} ", s["times"]["oracle"], "the bf16 forward")
        prof = s["times"]["profiles"]["decode"]
        log(f"{name}: decode step {s['times']['decode_step_ms']:.2f} ms, busy {prof['busy_share']:.1%}, B7 "
            f"{prof['b7_share']:.1%} of its {prof['kernel_ms']:.2f} ms of kernels; useful tokens/s "
            f"{s['times']['useful_tokens_per_s']:.1f}; TTFT mean {s['times']['ttft_mean_ms']:.1f} ms; serve peak "
            f"{s['times']['serve_peak_gib']:.2f} GiB; B7 path by shape {json.dumps(s['paths'])}")

    def check_served(name, s, stop, eos, room):
        """Budgets clamped to the cache's ``room(prompt length)``, the EOS
        request stopped at its stop token."""
        for (S, budget, _), c in zip(SERVE_REQUESTS, s["comps"]):
            if c.prompt_len != S or (c.finish_reason == "length" and c.steps != min(budget, room(S))):
                raise AssertionError(f"{name} serve request {c.request_id}: {c.steps} tokens for budget {budget}")
        ce = s["comps"][SERVE_EOS]
        if ce.finish_reason != "eos" or not np.array_equal(ce.tokens, stop):
            raise AssertionError(f"{name}: the EOS request did not stop at its first {eos} ({ce.tokens} vs {stop})")

    def train(name, cfg, fl, n_samples):
        model = build_model(cfg)
        vec, out = train_vectorized(name, cfg, model, make_runner, make_loss_fn, fl,
                                    family_world(cfg, data_mod, fl, n_samples), ops)
        counts["masked_adamw_update_stacked"] += out["padded_steps"]
        log(f"{name}: GAL layers {out['gal_layers']} of {len(vec.gal_layers)} logical layers")
        return vec, out

    # (i) whisper-large-v3 at full width, its depth cut: serving
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["whisper-large-v3"], num_layers=WHISPER_SERVE_LAYERS,
                              encoder_layers=WHISPER_SERVE_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(24)
    params = model.init_params(gen, "cuda")
    adapters = dense_adapters(model, gen)
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    eos, stop, _ = eos_from_probe(ServeEngine, model, params, adapters,
                                  serve_requests(Request, SamplingParams, cfg), SERVE_CACHE)
    free_memory()
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg, eos), cache_len=SERVE_CACHE,
                    # B8 over each encoder layer (bidirectional) and each decoder layer's
                    # prompt (causal); B7 on the encoder's wq-wo and the decoder's wq-wo
                    # and cwq-cwo at prefill, its few-row path on wq-wo and cwq/cwo a step
                    launches=lambda st: only(flash_attention=(Le + Ld) * st["prefill_calls"],
                                             batched_sparse_lora_apply=(4 * Le + 8 * Ld) * st["prefill_calls"],
                                             batched_sparse_lora_few_rows=6 * Ld * st["decode_steps"]),
                    oracle=dict(rel=SERVE_LOGIT_REL), b7_target="decoder/wq", label="whisper ")
    check_served("whisper", s, stop, eos, lambda S: SERVE_CACHE - S)
    dec_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, s["groups"], s["gen"], "whisper decoder ")
    enc_errs, b8_enc = b8_serve_checks(ops, ref, flash_attention, cfg,
                                       [(g, cfg.encoder_seq_len) for g, _ in s["groups"]], s["gen"],
                                       "whisper encoder ", causal=False)
    # B7 at the row counts of the encoder's output: its own targets and the
    # decoder's cross-attention K/V projections
    scale, gen = cfg.lora_alpha / cfg.lora_rank, s["gen"]
    b7_enc = {}
    for g in sorted({g for g, _ in s["groups"]}):
        idx = torch.arange(g, dtype=torch.int32, device="cuda").repeat_interleave(cfg.encoder_seq_len)
        for t, (a, b) in slot_leaves(s["lora_t"]).items():
            if t.startswith("encoder/") or t in ("decoder/cwk", "decoder/cwv"):
                a, b = a[:g].contiguous(), b[:g].contiguous()
                ones = torch.ones(g, b.shape[-1], device="cuda")
                x = torch.randn(g * cfg.encoder_seq_len, a.shape[1], generator=gen, device="cuda").bfloat16()
                e = check_lora(ops.batched_sparse_lora_apply(x, idx, a, b, ones, scale),
                               ref.batched_sparse_lora_matmul_ref(x, idx, a, b, ones, scale), f"whisper B7 serve {t}")
                path = sparse_lora.batched_path(x.shape[0], x.shape[1], b.shape[-1], cfg.lora_rank, x.dtype, g)
                b7_enc[f"B7 {t} {g}x{cfg.encoder_seq_len}"] = e
                name = "batched_sparse_lora_split" if path == "split" else "batched_sparse_lora_apply"
                errs[name] = max(errs[name], e)
    log(f"whisper B7 and B8 vs plain at the serve shapes: within tolerance; max abs err "
        f"{json.dumps({**s['errs'], **b7_enc, **{f'B8 decoder {k}': e for k, e in dec_errs.items()}, **{f'B8 encoder {k}': e for k, e in enc_errs.items()}})}")
    served("whisper-large-v3", s, "flash_attention", {**dec_errs, **enc_errs})
    times["whisper-large-v3"] = dict(s["times"], b8_prefill=b8, b8_encoder=b8_enc, seconds=time.perf_counter() - t0)
    del params, adapters, s, model
    free_memory()

    # (ii) whisper's width, depth cut: training
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["whisper-large-v3"], num_layers=WHISPER_TRAIN_LAYERS,
                              encoder_layers=WHISPER_TRAIN_LAYERS)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=1, batch_size=FAMILY_BATCH)
    vec, out = train(f"whisper-large-v3 ({cfg.encoder_layers} + {cfg.num_layers} layers)", cfg, fl, FAMILY_SAMPLES)
    times["whisper-large-v3_train"] = dict(out, seconds=time.perf_counter() - t0)
    del vec
    free_memory()

    # (iii) paligemma-3b at full width and depth: serving
    t0 = time.perf_counter()
    cfg = ARCHS["paligemma-3b"]
    P = cfg.num_prefix_embeddings
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(25)
    params = model.init_params(gen, "cuda")
    adapters = dense_adapters(model, gen)
    eos, stop, _ = eos_from_probe(ServeEngine, model, params, adapters,
                                  serve_requests(Request, SamplingParams, cfg), PALIGEMMA_CACHE)
    free_memory()
    s = serve_phase(ops, ref, sparse_lora, model, params, adapters,
                    lambda: serve_requests(Request, SamplingParams, cfg, eos), cache_len=PALIGEMMA_CACHE,
                    launches=dense_serve_launches(cfg.num_layers), oracle=dict(rel=SERVE_LOGIT_REL), b7_target="wq",
                    label="paligemma ")
    check_served("paligemma", s, stop, eos, lambda S: PALIGEMMA_CACHE - P - S)
    b8_errs, b8 = b8_serve_checks(ops, ref, flash_attention, cfg, [(g, P + S) for g, S in s["groups"]], s["gen"],
                                  "paligemma ")
    log(f"paligemma B7 and B8 (D {cfg.resolved_head_dim}) vs plain at the serve shapes: within tolerance; max abs err "
        f"{json.dumps({**s['errs'], **{f'B8 {k}': e for k, e in b8_errs.items()}})}")
    served("paligemma-3b", s, "flash_attention_d256", b8_errs)
    times["paligemma-3b"] = dict(s["times"], b8_prefill=b8, seconds=time.perf_counter() - t0)
    del params, adapters, s, model
    free_memory()

    # (iv) paligemma's width, depth cut: training on prefix rows
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["paligemma-3b"], num_layers=PALIGEMMA_TRAIN_LAYERS)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=1, batch_size=FAMILY_BATCH)
    vec, out = train(f"paligemma-3b ({cfg.num_layers} layers)", cfg, fl, FAMILY_SAMPLES)
    times["paligemma-3b_train"] = dict(out, seconds=time.perf_counter() - t0)
    del vec
    free_memory()

    # (v) roberta-large at full width and depth: the loop engine's Fisher
    # difficulty, then the vectorized engine's training and evaluate
    t0 = time.perf_counter()
    cfg = ARCHS["roberta-large"]
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=ROBERTA_ROUNDS, batch_size=4)
    clients = family_world(cfg, data_mod, fl, 256)
    with Launches(ops) as run:
        loop = make_runner("fibecfed", model, make_loss_fn(model), fl, clients, optimizer="adamw",
                           fused_optimizer=True, engine="loop", seed=0)
        _, loop_s = timed(loop._compute_difficulty)
    if any(run.counts.values()):
        raise AssertionError(f"roberta's Fisher difficulty launched a kernel: {run.counts}")
    loop_difficulty = [c.difficulty.copy() for c in loop.clients]
    del loop
    free_memory()
    vec, out = train_vectorized("roberta-large", cfg, model, make_runner, make_loss_fn, fl, clients, ops)
    counts["masked_adamw_update_stacked"] += out["padded_steps"]
    gap, swaps, spread = difficulty_gap(loop_difficulty, [c.difficulty for c in vec.clients])
    log(f"roberta-large vectorized vs loop Fisher difficulty per batch ({loop_s:.2f} s on the loop engine): largest "
        f"relative gap {gap:.4g} (limit {DIFFICULTY_RTOL}); {swaps} batch pairs ordered differently, their loop "
        f"scores at most {spread:.4g} apart (relative)")
    if gap > DIFFICULTY_RTOL or spread > 2 * gap:
        raise AssertionError("roberta's vectorized difficulty scores disagree with the loop engine's")
    task = data_mod.make_keyword_task(n_samples=64, seq_len=64, vocab_size=cfg.vocab_size, seed=1)
    test = {"tokens": task.data["tokens"], "labels": (task.data["label"] % cfg.num_classes).astype(np.int32)}
    with Launches(ops) as run:
        acc, eval_s = timed(lambda: vec.evaluate(test, batch_size=32))
    log(f"roberta-large evaluate: class accuracy {acc:.4f} on {len(test['labels'])} samples ({eval_s:.2f} s); "
        f"launches {run.counts}")
    if not 0.0 <= acc <= 1.0 or any(run.counts.values()):
        raise AssertionError(f"roberta evaluate: accuracy {acc}, launches {run.counts}")
    times["roberta-large_train"] = dict(out, difficulty_gap=gap, accuracy=acc, seconds=time.perf_counter() - t0)
    del vec, model
    free_memory()
    log(f"phase j: {time.perf_counter() - t_phase:.1f} s")
    return counts, errs, times


def full_f32():
    """Float32 matmuls in full f32: TF32 off for matmuls and cuDNN alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def qwen2_world(ARCHS, FibecFedConfig, data_mod, build_model, make_loss_fn):
    """Phase 4's world, the same in either process: qwen2-0.5b at full width
    and depth, the keyword task over 8 clients, 2 rounds of 4."""
    cfg = ARCHS["qwen2-0.5b"]
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=8, devices_per_round=4, rounds=2, batch_size=4)
    return cfg, model, make_loss_fn(model), fl, keyword_world(cfg.vocab_size, data_mod, fl)


class SecondProcess:
    """Phases k and l(i) in a second process on this card (``chip_smoke.py
    --phases-k-l STATE``), started after phase j, the last phase that times
    the device, from phase 4's records (``loop``) and the snapshots of
    phases 4 and 5 (``snaps``), handed over in ``STATE`` beside the
    snapshots. It runs beside phases 5e, 6, m, 7, g and l(ii) of this
    process, which check and time nothing on the device either. Its standard
    error is this process's; its standard output goes to a file that
    ``join`` copies into this one's. It ends with this process, whichever
    way this one ends."""

    def __init__(self, root, state, t_start):
        self.root = root
        path = os.path.join(root, "phases_k_l.pt")
        since = time.time() - (time.perf_counter() - t_start)  # the first process's start, on the wall clock
        torch.save(dict(state, since=since, parent=os.getpid()), path)
        self.out = open(os.path.join(root, "phases_k_l.log"), "w+")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phases-k-l", path],
                                     stdout=self.out)
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def join(self):
        """Wait for the process; copy its log; its launches, or raise if it
        failed (its traceback is on standard error)."""
        rc = self.proc.wait()
        self.out.seek(0)
        sys.stdout.write(self.out.read())
        sys.stdout.flush()
        self.out.close()
        if rc != 0:
            raise AssertionError(f"phases k and l(i) failed in their process (exit code {rc})")
        with open(os.path.join(self.root, "phases_k_l.json")) as f:
            return json.load(f)


def free_memory():
    """Collect the reference cycles a served engine leaves (its model's
    prefill and decode hooks refer back to it), then return the cached
    blocks to the card, so the next model starts from an empty card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_lossless(ops, make_runner, data_mod, FibecFedConfig, ARCHS, build_model, make_loss_fn):
    """Phase g: the lossless criteria on the card. The loop runner with masked
    SGD (fused: B2 per client step), ``gal_fraction=None`` and
    ``sparse_ratio=None``, at qwen2-0.5b's width cut to ``LOSSLESS_LAYERS``
    layers, one round. Each client's Ritz values, Lipschitz estimate and
    fraction, the GAL count (recomputed from the fractions) and each
    client's neuron masks (its ρ of every target's columns, ties kept) are
    checked and printed. On the card this is a timing and plumbing smoke of
    the lossless path at width: at this depth and Lanczos count no eigengap
    has cleared 4·L so far (every fraction 1.0, all layers global), so a
    cut, a fraction below 1 and its masks, is held against JAX only on the
    CPU (tests/test_torch_lossless.py). Returns the launch counts."""
    from repro_torch.core.gal import gal_layer_count

    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"], num_layers=LOSSLESS_LAYERS)
    model = build_model(cfg)
    fl = FibecFedConfig(num_devices=LOSSLESS_CLIENTS, devices_per_round=LOSSLESS_CLIENTS, rounds=1, batch_size=4,
                        gal_fraction=None, sparse_ratio=None, lanczos_iters=LOSSLESS_ITERS)
    clients = keyword_world(cfg.vocab_size, data_mod, fl)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Launches(ops) as run:
        r = make_runner("fibecfed", model, make_loss_fn(model), fl, clients, optimizer="sgd", fused_optimizer=True,
                        engine="loop", seed=0)
        _, init_s = timed(r.init_phase)
        stats, secs = timed(lambda: r.run_round(0))
    check_round(r, cfg, stats, 0)
    steps = int(r.last_round_info["client_steps"].sum())
    info = []
    for ci, c in enumerate(r.clients):
        eigs, lip, frac = c.lossless["eigs"], c.lossless["lipschitz"], c.lossless_fraction
        if not (np.all(np.isfinite(eigs)) and 1 <= len(eigs) <= LOSSLESS_ITERS and np.all(np.diff(eigs) >= 0)
                and math.isfinite(lip) and lip >= 0 and 0.0 < frac <= 1.0):
            raise AssertionError(f"lossless client {ci}: Ritz values {eigs}, Lipschitz {lip}, fraction {frac}")
        for t, ab in c.neuron_mask["layers"].items():
            d_out = ab["b"].shape[-1]
            kept = ab["b"][:, 0].sum(dim=-1)  # a neuron's mask is one column of b, the same at every rank
            if bool((kept < max(1, round(frac * d_out))).any()):
                raise AssertionError(f"lossless client {ci}: {t} keeps fewer than ρ = {frac} of its neurons")
        info.append(dict(client=ci, ritz=[float(v) for v in eigs], lipschitz=lip, fraction=frac))
    n_gal = gal_layer_count([c.lossless_fraction for c in r.clients], [c.n for c in r.clients], cfg.num_layers,
                            fl.mu_global_local)
    log(f"lossless (qwen2-0.5b width, {cfg.num_layers} layers, {LOSSLESS_CLIENTS} clients, Lanczos "
        f"{LOSSLESS_ITERS}): init_phase {init_s:.2f} s, round 0 {secs:.2f} s, {json.dumps(stats)}; GAL layers "
        f"{np.flatnonzero(r.gal_layers).tolist()} ({int(np.sum(r.gal_layers))}, from the fractions {n_gal}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {run.counts}")
    for e in info:
        log(f"lossless client {e['client']}: Ritz values {[round(v, 6) for v in e['ritz']]}, Lipschitz "
            f"{e['lipschitz']:.6g}, fraction {e['fraction']:.4f}")
    if int(np.sum(r.gal_layers)) != n_gal:
        raise AssertionError("the GAL count does not follow the clients' lossless fractions")
    if run.counts != only(masked_sgd_update=steps) or steps == 0:
        raise AssertionError(f"the lossless run did not launch the SGD kernel once per step: {run.counts}")
    return {"masked_sgd_update": run.counts["masked_sgd_update"]}


def recording_train(runner):
    """Record each local round of an async runner: (client, real steps,
    the global version it pulled, its LoRA after training). Wraps the
    runner's train callback; the run itself is unchanged. The wrapper
    refers back to the runner: only the cycle collector frees it."""
    trained = []
    callbacks = runner._async_callbacks

    def wrapped(lr, sched):
        plan, train = callbacks(lr, sched)

        def train_rec(ci, t, version):
            pulled = runner._global.front
            u = train(ci, t, version)
            trained.append((ci, u.n_steps, pulled, runner.clients[ci].lora))
            return u

        return plan, train_rec

    runner._async_callbacks = wrapped
    return trained


def drive_async(ops, make_runner, label, rounds, args, after_round=None, init_from=None, keep_init=None, **kw):
    """Build an async runner, init it and run ``rounds`` merges with the
    launch counts zeroed around it. Logs init s, wall s per merge, virtual
    time, staleness, peak memory and launches. ``init_from``: a snapshot
    taken right after an earlier async run's init on the same world with the
    same init settings (the scenario, the async policies and the edges do
    not enter the init), restored through the port's ``restore_runner`` in
    place of the init; ``keep_init`` = (root, name): snapshot this run right
    after its init, for such a run."""
    from repro_torch.checkpoint import restore_runner

    torch.cuda.reset_peak_memory_stats()
    init_snap = None
    with Launches(ops) as run:
        r = make_runner(*args, engine="async", seed=0, **kw)
        trained = recording_train(r)
        if init_from is None:
            _, init_s = timed(r.init_phase)
        else:
            _, init_s = timed(lambda: restore_runner(r, init_from["path"]))
        if keep_init is not None:
            init_snap = take_snapshot(*keep_init, r, 0)
        hist, walls, chosen = [], [], []
        for t in range(rounds):
            stats, secs = timed(lambda: r.run_round(t))
            hist.append(stats)
            walls.append(secs)
            chosen.append(r.last_round_info["chosen"].copy())
            if after_round is not None:
                after_round(t, r)
    peak = torch.cuda.max_memory_allocated() / 2**30
    how = "init" if init_from is None else "the init restored from its snapshot in"
    log(f"async {label}: {how} {init_s:.2f} s; wall s per merge {[round(w, 3) for w in walls]}; virtual time "
        f"{[h['virtual_time'] for h in hist]}; staleness {[h['staleness_mean'] for h in hist]}; merged "
        f"{[int(h['merged_clients']) for h in hist]}; buffer {[int(h['buffer_size']) for h in hist]}; losses "
        f"{[h['loss'] for h in hist]}; peak {peak:.2f} GiB; launches {run.counts}; local rounds {len(trained)}, "
        f"steps {sum(n for _, n, _, _ in trained)}")
    return dict(runner=r, hist=hist, walls=walls, chosen=chosen, trained=trained, counts=run.counts,
                init_s=init_s, peak=peak, init_snap=init_snap)


def phase_async(ops, make_runner, AsyncAggConfig, CompressionConfig, model, loss_fn, fl, clients, cfg, loop,
                tree_leaves, snaps, ckpt_root):
    """Phase k: the async engine on phase 4's world. (i) the degenerate
    configuration against phase 4's loop run; (ii) stragglers with every
    adaptive policy, snapshotted for phase l after merge
    ASYNC_SNAPSHOT_AFTER (``snaps["async"]``); (iii) compressed uploads with
    the constrained scenario's ranks, flat and through two edges. Returns
    the launches."""
    t_phase = time.perf_counter()
    free_memory()  # what earlier phases left to the cycle collector
    args = ("fibecfed", model, loss_fn, fl, clients)
    # --- k(i): uniform scenario, the cohort as buffer: the loop round ---
    from repro_torch.core import curriculum as curr
    from repro_torch.utils.tree import tree_clone

    eps = torch.finfo(torch.float32).eps

    def reassoc(g_async, g_loop, client_loras):
        """The largest |async - loop| merge difference, in units of
        MERGE_REASSOC_ULPS f32 ulp of the clients' largest |x| there."""
        xs = [tree_leaves(c) for c in client_loras]
        return max(((ga - gl).abs() / (MERGE_REASSOC_ULPS * eps * torch.stack(x).abs().amax(0))).nan_to_num(0.0)
                   .max().item() for ga, gl, *x in zip(tree_leaves(g_async), tree_leaves(g_loop), *xs))

    def lora_diff(r, loop_clients):
        return {int(ci): max((a - b).abs().max().item() for a, b in
                             zip(tree_leaves(r.clients[ci].lora), tree_leaves(loop_clients[int(ci)])))
                for ci in r.last_round_info["chosen"]}

    readings = []

    def keep_round(t, r):
        clients = loop["clients0" if t == 0 else "clients1"]
        g_loop = loop["global0"] if t == 0 else loop["global_lora"]
        readings.append((lora_diff(r, clients), reassoc(r.global_lora, g_loop, clients.values())))
        if t == 0:  # round 1 pulls the loop's round-0 global in place of the async merge 0
            r._global.front = r.global_lora = tree_clone(loop["global0"])

    # k(i) keeps its own init (held to phase 4's below); k(ii) restores it
    k1 = drive_async(ops, make_runner, "k(i) degenerate", fl.rounds, args, after_round=keep_round,
                     keep_init=(ckpt_root, "async_init"), optimizer="adamw", fused_optimizer=True)
    async_init = k1["init_snap"]
    r, hist = k1["runner"], k1["hist"]
    if not (all(np.array_equal(a, c.order) for a, c in zip(loop["orders"], r.clients))
            and np.array_equal(loop["gal_layers"], r.gal_layers)):
        raise AssertionError("k(i): the async curriculum orders or GAL layers differ from the loop engine's")
    # the same cohorts; a merge lists its clients as they complete on the
    # virtual clock (fewer steps first), the loop round as it drew them
    if not all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(loop["chosen"], k1["chosen"])):
        raise AssertionError(f"k(i): cohorts {k1['chosen']} differ from the loop engine's {loop['chosen']}")
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist, loop["stats"])]
    for t, (diffs, merge) in enumerate(readings):
        log(f"k(i) round {t}: clients' LoRA against phase 4's, max abs diff by client {diffs} (limit "
            f"{ROUND0_LORA_ATOL}); loss rel {loss_rel[t]:.3g} (limit 1e-6); merge {t} against phase 4's FedAvg: "
            f"largest |diff| {merge:.3g} of {MERGE_REASSOC_ULPS} ulp of the clients' largest |x| (limit 1)")
        if sorted(diffs) != sorted(loop["clients0" if t == 0 else "clients1"]) or \
                max(diffs.values()) > ROUND0_LORA_ATOL or loss_rel[t] > 1e-6:
            raise AssertionError(f"k(i): round {t}'s local training differs from the loop engine's")
        if merge > 1.0:
            raise AssertionError(f"k(i): merge {t} is not the loop engine's FedAvg up to f32 reassociation")
    for t, stats in enumerate(hist):
        if not math.isfinite(stats["loss"]):
            raise AssertionError(f"k(i): merge {t}'s loss is not finite")
        if stats["staleness_mean"] != 0.0 or stats["dropped_clients"] != 0.0 or stats["stale_dropped"] != 0.0:
            raise AssertionError(f"k(i): merge {t} is not the synchronous round: {stats}")
    want = [expected_comm_bytes(cfg, r.global_lora, r.gal_layers, chosen)[0] for chosen in k1["chosen"]]
    if r.comm_bytes_per_round != loop["comm"] or r.comm_bytes_per_round != want:
        raise AssertionError(f"k(i): comm bytes {r.comm_bytes_per_round}, loop {loop['comm']}, recomputed {want}")
    if r._global.version != fl.rounds:
        raise AssertionError(f"k(i): global version {r._global.version}")
    dis = [engine_disagreement(gl, ga, g0) for gl, ga, g0 in
           zip(tree_leaves(loop["global_lora"]), tree_leaves(r.global_lora), tree_leaves(loop["init_lora"]))]
    log(f"k(i) against phase 4: final global LoRA per leaf (fraction disagreeing, max diff / largest update): "
        f"{[(round(f, 6), round(m, 6)) for f, m in dis]}")
    if max(f for f, _ in dis) > ENGINE_AGREE_FRAC or max(m for _, m in dis) > 2.0:
        raise AssertionError("k(i): the async run's global disagrees with the loop engine's")
    steps = sum(n for _, n, _, _ in k1["trained"])
    if k1["counts"] != only(masked_adamw_update=steps) or steps != loop["steps"]:
        raise AssertionError(f"k(i): B1 launches {k1['counts']} for {steps} valid steps (loop {loop['steps']})")

    launches = {"masked_adamw_update": k1["counts"]["masked_adamw_update"]}
    del r, k1
    free_memory()  # the recording wrapper makes each runner a reference cycle

    # --- k(ii): the straggler scenario with every adaptive policy ---
    from repro_torch.obs import Telemetry

    tel = Telemetry(run_id="k(ii)")

    def snapshot(t, r):
        if t == ASYNC_SNAPSHOT_AFTER:
            sched = r._scheduler
            snaps["async"] = dict(take_snapshot(ckpt_root, "async", r, t + 1), in_flight=sorted(sched.in_flight),
                                  heap_payloads=sum(ev.payload is not None for ev in sched._heap),
                                  buffered=len(sched.buffer))

    k2 = drive_async(ops, make_runner, "k(ii) straggler", ASYNC_MERGES, args, after_round=snapshot,
                     init_from=async_init, optimizer="adamw", fused_optimizer=True, scenario="straggler",
                     async_cfg=AsyncAggConfig(**STRAGGLER_POLICIES), telemetry=tel)
    r, hist = k2["runner"], k2["hist"]
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("k(ii): a loss is not finite")
    if any(h["staleness_mean"] > STRAGGLER_POLICIES["staleness_cutoff"] or not 1 <= h["buffer_size"] <= 2
           for h in hist) or not any(h["staleness_mean"] > 0 for h in hist):
        raise AssertionError("k(ii): staleness or buffer size out of bounds, or no update landed stale")
    clock = [h["virtual_time"] for h in hist]
    if any(b < a for a, b in zip(clock, clock[1:])) or not clock[-1] > clock[0]:
        raise AssertionError(f"k(ii): the virtual clock does not advance: {clock}")
    sched = r._scheduler
    plan, _ = r._async_callbacks(fl.learning_rate, sched)
    slow = int(np.argmax(sched.scenario.speed))

    full = len(curr.selected_batch_ids(r.schedule, 0, r.clients[slow].order))
    if sched.scenario.rel_speed(slow) != 4.0 or plan(slow, 0) != max(1, math.ceil(full / 4)):
        raise AssertionError(f"k(ii): the slowest client's plan {plan(slow, 0)} is not ceil({full}/4)")
    per_client = expected_comm_bytes(cfg, r.global_lora, r.gal_layers, [0])
    completions = [int(h["merged_clients"] + h["stale_dropped"]) for h in hist]
    want = ([n * per_client[0] for n in completions], [n * per_client[1] for n in completions])
    if (r.comm_bytes_per_round, r.comm_upload_bytes_per_round) != want:
        raise AssertionError(f"k(ii): comm bytes {r.comm_bytes_per_round} != {want[0]} by completion")
    spans = [e for e in tel.tracer.events if e["clock"] == "virtual" and e["type"] == "span"]
    up = sum(e["args"]["upload_bytes"] for e in spans if e["name"] == "upload")
    down = sum(e["args"]["download_bytes"] for e in spans if e["name"] == "dispatch")
    n_up = sum(1 for e in spans if e["name"] == "upload")
    if (up, down, n_up) != (sum(want[1]), sum(want[0]) - sum(want[1]), sum(completions)) or \
            tel.snapshot()["counters"]["async.merges"] != ASYNC_MERGES:
        raise AssertionError(f"k(ii): the virtual upload spans ({up}, {down}, {n_up}) do not add up to the comm bytes")
    log(f"k(ii): completions by merge {completions}, {per_client[0]} bytes each; upload spans {n_up}, {up} bytes; "
        f"slowest client {slow}'s plan {plan(slow, 0)} of {full}")
    steps = sum(n for _, n, _, _ in k2["trained"])
    if k2["counts"] != only(masked_adamw_update=steps):
        raise AssertionError(f"k(ii): B1 launches {k2['counts']} for {steps} valid steps")
    launches["masked_adamw_update"] += k2["counts"]["masked_adamw_update"]
    snaps["async"].update(hist=hist, comm=list(r.comm_bytes_per_round), upload=list(r.comm_upload_bytes_per_round),
                          global_lora=tree_clone(r.global_lora))
    del r, sched, plan, k2, tel
    free_memory()

    # --- k(iii): compressed uploads, ranks from the constrained scenario,
    # the edge tier against the flat merge ---
    comp = CompressionConfig(**COMPRESSION)
    runs, k3_init = {}, None
    for hierarchy in (2, None):  # the flat run restores the edge run's init (the edges do not enter it)
        k3 = drive_async(ops, make_runner, f"k(iii) constrained, compressed, hierarchy={hierarchy}", 2,
                         (PHASE6_BASELINE,) + args[1:], optimizer="sgd", fused_optimizer=True,
                         scenario="constrained", compression=comp, async_cfg=AsyncAggConfig(buffer_size=2),
                         hierarchy=hierarchy, init_from=k3_init,
                         keep_init=(ckpt_root, "async_compressed_init") if k3_init is None else None)
        k3_init = k3_init or k3["init_snap"]
        r, ranks = k3["runner"], k3["runner"].client_ranks
        if ranks is None or not (ranks < cfg.lora_rank).any():
            raise AssertionError(f"k(iii): the constrained scenario derived no low ranks: {ranks}")
        for t in range(len(k3["hist"])):
            want = expected_comm_bytes(cfg, r.global_lora, r.gal_layers, k3["chosen"][t], comp, ranks)
            if (r.comm_bytes_per_round[t], r.comm_upload_bytes_per_round[t]) != want:
                raise AssertionError(f"k(iii): merge {t}'s comm bytes differ from the wire format {want}")
        for ci, _, pulled, lora in k3["trained"]:
            rank = int(ranks[ci])
            for name, ab in lora["layers"].items():
                p = pulled["layers"][name]
                if not (torch.equal(ab["a"][..., rank:], p["a"][..., rank:])
                        and torch.equal(ab["b"][:, rank:], p["b"][:, rank:])):
                    raise AssertionError(f"k(iii): client {ci} (rank {rank}) moved beyond its rank in {name}")
        steps, uploads = sum(n for _, n, _, _ in k3["trained"]), len(k3["trained"])
        if k3["counts"] != only(masked_sgd_update=steps, fake_compress=uploads):
            raise AssertionError(f"k(iii): launches {k3['counts']} for {steps} steps and {uploads} uploads")
        launches["masked_sgd_update"] = launches.get("masked_sgd_update", 0) + steps
        launches["fake_compress"] = launches.get("fake_compress", 0) + uploads
        runs[hierarchy] = k3
    (e2, flat) = runs[2], runs[None]
    host = [{k: v for k, v in h.items() if k != "loss"} for h in flat["hist"]]
    if host != [{k: v for k, v in h.items() if k != "loss"} for h in e2["hist"]] or \
            not all(np.array_equal(a, b) for a, b in zip(flat["chosen"], e2["chosen"])) or \
            flat["runner"].comm_bytes_per_round != e2["runner"].comm_bytes_per_round or \
            not np.array_equal(flat["runner"].client_ranks, e2["runner"].client_ranks):
        raise AssertionError("k(iii): two edges and the flat merge made different decisions")
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(e2["hist"], flat["hist"]))
    dis = [engine_disagreement(gf, ge, g0) for gf, ge, g0 in
           zip(tree_leaves(flat["runner"].global_lora), tree_leaves(e2["runner"].global_lora),
               tree_leaves(flat["runner"]._init_lora))]
    log(f"k(iii) two edges against flat: ranks {flat['runner'].client_ranks.tolist()}; loss rel {loss_rel:.3g}; "
        f"global LoRA per leaf (fraction disagreeing, max diff / largest update): "
        f"{[(round(f, 6), round(m, 6)) for f, m in dis]}")
    if loss_rel > ENGINE_LOSS_RTOL or max(f for f, _ in dis) > ENGINE_AGREE_FRAC or max(m for _, m in dis) > 2.0:
        raise AssertionError("k(iii): two edges and the flat merge disagree")
    del runs, e2, flat
    free_memory()
    log(f"phase k: {time.perf_counter() - t_phase:.1f} s")
    return launches


def resume(ops, make_runner, args, snap, rounds, **kw):
    """A fresh runner restores ``snap`` into the card's memory and runs its
    remaining rounds (merges) up to ``rounds``, the launch counts zeroed
    around it. Returns the runner, its stats, restore s, wall s per round,
    launches and the optimizer steps its rounds took."""
    from repro_torch.checkpoint import restore_runner

    with Launches(ops) as run:
        r = make_runner(*args, seed=0, **kw)
        trained = recording_train(r) if r.engine == "async" else []
        _, restore_s = timed(lambda: restore_runner(r, snap["path"]))
        hist, walls, steps = [], [], 0
        for t in range(snap["next_round"], rounds):
            stats, secs = timed(lambda: r.run_round(t))
            hist.append(stats)
            walls.append(secs)
            if r.engine == "vectorized":
                steps += int(stats["padded_steps"])  # the stacked B1 steps every padded step
            elif r.engine == "loop":
                steps += int(r.last_round_info["client_steps"].sum())
    steps += sum(n for _, n, _, _ in trained)
    return dict(runner=r, hist=hist, walls=walls, restore_s=restore_s, counts=run.counts, steps=steps)


def adopt_decisions(runner, orders, masks, gal_layers):
    """Give an initialized in-memory vectorized runner another run's
    curriculum orders, neuron masks and GAL layers."""
    from repro_torch.lora import gal_mask_tree
    from repro_torch.utils.tree import tree_map

    runner.gal_layers = np.array(gal_layers)
    runner._gal_mask_tree = gal_mask_tree(runner.cfg, runner.global_lora, runner.gal_layers)
    runner._gal_leaf_cache, runner._comm_bytes_cache = None, {}
    runner._stacked_mask = tree_map(lambda *xs: torch.stack(xs), *masks)
    for ci, c in enumerate(runner.clients):
        c.order = np.array(orders[ci])
        c.neuron_mask = tree_map(lambda x, ci=ci: x[ci], runner._stacked_mask)


def lora_diffs(a, b, tree_leaves):
    """(largest |a - b|, largest excess over ASYNC_RESUME_ATOL + _RTOL·|b|)."""
    d = [(x - y).abs() for x, y in zip(tree_leaves(a), tree_leaves(b))]
    excess = [(di - ASYNC_RESUME_ATOL - ASYNC_RESUME_RTOL * y.abs()).max().item() for di, y in zip(d, tree_leaves(b))]
    return max(di.max().item() for di in d), max(excess)


def plain_masked_adamw(ops, ref):
    """``launch.steps.masked_adamw`` with B1's plain version in place of the
    kernel, on card tensors: the oracle of phase n(i)."""
    from repro_torch.utils.tree import tree_map, tree_unzip

    def update(params, grads, m, v, t, mask, lr):
        t_new, mhat, vhat = ops.adam_step_scales(t, None, 0.9, 0.999)
        lr_t = ops.as_f32(lr, t.device)
        out = tree_map(lambda p, g, mm, vv, mk: ref.masked_adamw_update_ref(p, g, mm, vv, mk, lr_t, mhat, vhat),
                       params, grads, m, v, mask)
        new_p, new_m, new_v = tree_unzip(out, 3)
        return new_p, new_m, new_v, t_new

    return update


def check_launch_freeze(start, state, what):
    """A launch-layer train step's frozen entries, bit for bit to the
    start: the GAL tree and its moments where the GAL mask is 0, the local
    tree and its moments where (1 - GAL mask) x local mask is 0; and each
    ``b`` leaf moved where it trains."""
    from repro_torch.utils.tree import tree_items

    old = dict(tree_items(start))
    for k, x in tree_items(state):
        kind, _, path = k.partition("/")
        if kind in ("gal_lora", "gal_m", "gal_v"):
            live = old[f"gal_mask/{path}"].expand(x.shape) != 0
        elif kind in ("local_lora", "local_m", "local_v"):
            live = ((1.0 - old[f"gal_mask/{path}"])[None] * old[f"local_mask/{path}"]).expand(x.shape) != 0
        else:
            continue
        if not torch.equal(x[~live], old[k][~live]):
            raise AssertionError(f"{what}: a frozen entry of {k} moved")
        if k.endswith("/b") and bool(live.any()) and torch.equal(x[live], old[k][live]):
            raise AssertionError(f"{what}: {k} did not train where it is live")


def phase_launch(ops, ref, smi, tree_clone, tree_leaves):
    """Phase n: the launch layer at full qwen2-0.5b width. (i) the FibecFed
    train step through launch/train.py's code path, held to its B1-plain
    twin; (ii) the prefill (B8) and decode steps against the training
    forward; (iii) one train step under the profiler twin of hlo_stats and
    its roofline terms on H100_SXM. Returns the launches of (i) and (ii)."""
    from repro_torch.config import H100_SXM
    from repro_torch.configs import ARCHS
    from repro_torch.launch import analysis, prof_stats, steps, train

    cfg = ARCHS["qwen2-0.5b"]
    dev = torch.device("cuda")
    G, B, S, n = LAUNCH_GROUPS, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_STEPS
    model, params, state, gen = train.init_run(cfg, dev, G)
    start, gen_start = tree_clone(state), gen.get_state()
    with Launches(ops) as run:
        (st, losses), secs = timed(lambda: train.train_loop(
            steps.build_train_step(model, G, learning_rate=LAUNCH_LR), params, state, gen, cfg, B, S, n, log=None))
    if run.counts != only(masked_adamw_update=2 * n):
        raise AssertionError(f"the train step did not launch B1 twice a step: {run.counts}")
    gen.set_state(gen_start)
    plain_step = steps._build_train_step(model, G, LAUNCH_LR, plain_masked_adamw(ops, ref))
    (st_p, losses_p), secs_p = timed(lambda: train.train_loop(plain_step, params, tree_clone(start), gen, cfg, B, S,
                                                              n, log=None))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_p))
    leaf_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(tree_leaves(st), tree_leaves(st_p)))
    log(f"phase n(i) train step ({smi}): {G} groups x {B // G} x {S} tokens, {n} steps in {secs:.2f} s "
        f"(B1-plain twin {secs_p:.2f} s); losses {losses} vs {losses_p} (rel {rel:.3g}); state max abs diff "
        f"{leaf_err:.3g}; launches {run.counts['masked_adamw_update']}")
    if not all(math.isfinite(x) for x in losses) or rel > LAUNCH_LOSS_RTOL or leaf_err > ROUND0_LORA_ATOL:
        raise AssertionError("the train step and its B1-plain twin disagree")
    check_launch_freeze(start, st, "train step")
    check_launch_freeze(start, st_p, "B1-plain train step")
    if int(st["step"]) != n:
        raise AssertionError(f"step counter {int(st['step'])} after {n} steps")
    counts = {"masked_adamw_update": run.counts["masked_adamw_update"]}
    del st_p, start

    # (ii) prefill (B8) and decode, against the teacher-forced forward
    lora = st["gal_lora"]
    prompts = torch.randint(0, cfg.vocab_size, (LAUNCH_PROMPTS, S), generator=gen, device=dev)
    with Launches(ops) as run:
        (got, toks), serve_s = timed(lambda: launch_serve(model, params, lora, {"tokens": prompts}, LAUNCH_DECODE))
    if run.counts != only(flash_attention=cfg.num_layers):
        raise AssertionError(f"the prefill step did not take B8 once a layer: {run.counts}")
    counts["flash_attention"] = run.counts["flash_attention"]
    with torch.no_grad():
        want = model.forward(params, lora, {"tokens": torch.cat([prompts, toks], 1)})[0][:, S - 1:].float()
    err = float(row_err(got, want).max())
    log(f"phase n(ii) prefill {LAUNCH_PROMPTS}x{S} + {LAUNCH_DECODE} decode steps in {serve_s:.3f} s: logits "
        f"{err:.4f} of a row's largest |logit| from the training forward (limit {SERVE_LOGIT_REL}); B8 launches "
        f"{counts['flash_attention']}")
    if not bool(torch.isfinite(got).all()) or err > SERVE_LOGIT_REL:
        raise AssertionError("the prefill/decode steps' logits are off the training forward")
    q = torch.randn(LAUNCH_PROMPTS, S, cfg.num_heads, cfg.resolved_head_dim, generator=gen, device=dev).bfloat16()
    kk, vv = (torch.randn(LAUNCH_PROMPTS, S, cfg.num_kv_heads, cfg.resolved_head_dim, generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    b8_err = check_attention(ops.flash_attention(q, kk, vv, causal=True, window=cfg.attention_window),
                             ref.flash_attention_gqa_ref(q, kk, vv, causal=True, window=cfg.attention_window),
                             vv, f"B8 at the prefill step's shape {LAUNCH_PROMPTS}x{S}")

    # (iii) one train step profiled, counted and set against its roofline
    step = steps.build_train_step(model, G, learning_rate=LAUNCH_LR)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    _, wall_s = timed(lambda: step(params, st, batch))
    prof = prof_stats.profile_step(lambda: step(params, st, batch))
    _, counter = prof_stats.count_step(step, params, st, batch)
    n_params = sum(x.numel() for x in tree_leaves(params))
    mf = analysis.model_flops(cfg, n_params, n_params * analysis.active_param_fraction(cfg), B * S, "train")
    roof = analysis.roofline_terms(hlo_flops=counter.flops, hlo_bytes=counter.bytes_written, coll_bytes=0.0, chips=1)
    mfu = mf / (wall_s * H100_SXM.peak_flops)
    log(f"phase n(iii) train step ({smi}): {wall_s * 1e3:.1f} ms unprofiled; kernel {prof['kernel_ms']:.1f} ms "
        f"over {prof['launches']} launches, busy {prof['busy_share']:.1%} of {prof['wall_ms']:.1f} ms profiled; "
        f"peak memory {prof['max_memory_allocated'] / 2**30:.2f} GiB; counted {counter.flops / 1e12:.3f} TFLOP, "
        f"{counter.bytes_written / 1e9:.2f} GB written, {counter.ops} ops; model flops {mf / 1e12:.3f} TFLOP "
        f"({mfu:.2%} of the card's bf16 peak at the step's time); roofline on H100_SXM {json.dumps(roof)}; "
        f"top kernels {json.dumps(prof['top_kernels'][:5])}")
    if not (counter.flops > 0 and prof["launches"] > 0 and prof["kernel_ms"] > 0):
        raise AssertionError("the profiler twin saw no device work")
    return counts, b8_err


def launch_serve(model, params, lora, batch, n_decode):
    """The launch layer's prefill step over ``batch`` and ``n_decode``
    greedy decode steps: ``(logits (B, 1 + n_decode, V) f32, tokens)``."""
    from repro_torch.launch import steps

    S = batch["tokens"].shape[1]
    logits, cache = steps.build_prefill_step(model, cache_len=S + n_decode)(params, lora, batch)
    decode = steps.build_decode_step(model)
    got, toks = [logits[:, -1].float()], []
    for j in range(n_decode):
        toks.append(torch.argmax(got[-1], dim=-1, keepdim=True))
        logits, cache = decode(params, lora, toks[-1], cache, S + j)
        got.append(logits[:, -1].float())
    return torch.stack(got, 1), torch.cat(toks, 1)


def row_err(x, want):
    """Each row's largest |x - want| over its largest |want|."""
    return (x - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)


def family_kernels(cfg):
    """The kernel launches of one prefill step of ``cfg`` on the card: B9
    once a Mamba2 layer, B8 once per application of an attention over the
    prompt (the hybrid's shared block; whisper's encoder and decoder)."""
    if cfg.family == "ssm":
        return dict(ssd_chunk_intra=cfg.num_layers)
    if cfg.family == "hybrid":
        return dict(ssd_chunk_intra=cfg.num_layers, flash_attention=cfg.num_layers // cfg.hybrid_period)
    return dict(flash_attention=cfg.encoder_layers + cfg.num_layers)


def phase_launch_families(ops, ref, smi, tree_clone, tree_leaves, dev):
    """Phase o(i): the launch layer's train, prefill and decode steps of
    mamba2-1.3b, zamba2-7b and whisper-large-v3 at full width and cut
    depth, with no mesh; the train steps held to their B1-plain twin, the
    served logits to the teacher-forced training forward. Returns the
    launches and B8's largest error at whisper's prompt shape."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps, train
    from repro_torch.utils.tree import tree_map

    G, B, S, n = LAUNCH_GROUPS, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_FAMILY_STEPS
    counts = dict.fromkeys(LAUNCHED, 0)
    for name, cut in LAUNCH_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], **cut)
        torch.cuda.reset_peak_memory_stats()
        model, params, state, gen = train.init_run(cfg, dev, G)
        start, gen_start = tree_clone(state), gen.get_state()
        with Launches(ops) as run:
            (st, losses), secs = timed(lambda: train.train_loop(
                steps.build_train_step(model, G, learning_rate=LAUNCH_LR), params, state, gen, cfg, B, S, n,
                log=None))
        if run.counts != only(masked_adamw_update=2 * n):
            raise AssertionError(f"o(i) {name}: the train step did not launch B1 twice a step: {run.counts}")
        counts["masked_adamw_update"] += run.counts["masked_adamw_update"]
        gen.set_state(gen_start)
        plain_step = steps._build_train_step(model, G, LAUNCH_LR, plain_masked_adamw(ops, ref))
        (st_p, losses_p), secs_p = timed(lambda: train.train_loop(plain_step, params, tree_clone(start), gen, cfg, B,
                                                                  S, n, log=None))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_p))
        leaf_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(tree_leaves(st), tree_leaves(st_p)))
        log(f"phase o(i) {name} at {cfg.num_layers}" + (f" + {cfg.encoder_layers}" if cfg.encoder_layers else "")
            + f" layers, train step ({smi}): {G} groups x {B // G} x {S} tokens, {n} steps in {secs:.2f} s "
            f"(B1-plain twin {secs_p:.2f} s); losses {losses} vs {losses_p} (rel {rel:.3g}); state max abs diff "
            f"{leaf_err:.3g}; B1 launches {run.counts['masked_adamw_update']}")
        if not all(math.isfinite(x) for x in losses) or rel > LAUNCH_LOSS_RTOL or leaf_err > ROUND0_LORA_ATOL:
            raise AssertionError(f"o(i) {name}: the train step and its B1-plain twin disagree")
        check_launch_freeze(start, st, f"o(i) {name} train step")
        check_launch_freeze(start, st_p, f"o(i) {name} B1-plain train step")
        del st_p, start

        # the prefill (B9 and/or B8) and decode steps against the forward
        lora = st["gal_lora"]
        batch = train.random_batch(cfg, LAUNCH_PROMPTS, S, gen)
        with Launches(ops) as run:
            (got, toks), serve_s = timed(lambda: launch_serve(model, params, lora, batch, LAUNCH_FAMILY_DECODE))
        if run.counts != only(**family_kernels(cfg)):
            raise AssertionError(f"o(i) {name}: the prefill step did not take its kernels: {run.counts}")
        for k, v in run.counts.items():
            counts[k] += v
        full = dict(batch, tokens=torch.cat([batch["tokens"], toks], 1))
        with torch.no_grad():
            plain = model.forward(params, lora, full)[0][:, S - 1:].float()
            if cfg.family in ("ssm", "hybrid"):
                want = model.forward(tree_map(lambda x: x.float(), params), lora,
                                     {k: v.float() if v.is_floating_point() else v for k, v in full.items()}
                                     )[0][:, S - 1:].float()
                floor = float(row_err(plain, want).max())
                tol, what = SSM_FLOOR_RATIO * floor, f"{SSM_FLOOR_RATIO} x the plain bf16 forward's {floor:.4g}"
            else:
                want, tol, what = plain, SERVE_LOGIT_REL, "phase 5d's limit"
        err = float(row_err(got, want).max())
        log(f"phase o(i) {name} prefill {LAUNCH_PROMPTS}x{S} + {LAUNCH_FAMILY_DECODE} decode steps in {serve_s:.3f} "
            f"s: logits {err:.4g} of a row's largest |logit| from the training forward (limit {tol:.4g}: {what}); "
            f"launches {dict((k, v) for k, v in run.counts.items() if v)}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
        if not bool(torch.isfinite(got).all()) or err > tol:
            raise AssertionError(f"o(i) {name}: the prefill/decode steps' logits are off the training forward")
        del model, params, state, st, lora, batch, full, got, plain, want
        free_memory()
    # B8 against its plain version at whisper's prompt shape (4 x 128, 20 heads of 64, bf16)
    cfg = ARCHS["whisper-large-v3"]
    gen = torch.Generator(device=dev).manual_seed(0)
    q, kk, vv = (torch.randn(LAUNCH_PROMPTS, S, cfg.num_heads, cfg.resolved_head_dim, generator=gen,
                             device=dev).bfloat16() for _ in range(3))
    b8_err = check_attention(ops.flash_attention(q, kk, vv, causal=True, window=None),
                             ref.flash_attention_gqa_ref(q, kk, vv, causal=True, window=None), vv,
                             f"B8 at whisper's prompt step shape {LAUNCH_PROMPTS}x{S}")
    return counts, b8_err


def mixer_halves(ops, ssm, cfg, h, p, lo, scale, cache=None):
    """The Mamba2 mixer of one layer as the two ranks of a (1, 2) mesh run
    it (``sharding_ctx.local_ssm``): each rank's core over its nh / 2 heads
    (the prefill's scan on B9), then what DTensor does after them: the gated
    norm's sum of squares summed over the ranks, each rank's rows of
    ``out_proj`` and of its LoRA ``a``, the partial outputs summed. ``cache``
    (conv_buf, state): one decode step. Returns ``(out, conv window, state,
    the cores' launches)``."""
    from repro_torch.models.layers import linear

    dims = ssm.ssm_dims(cfg)
    half, hd, di = dims["nheads"] // 2, cfg.ssm.head_dim, dims["d_inner"]
    zxbcdt = linear(h, {"w": p["in_proj"]}, lo["in_proj"], scale)
    core = {k: p[k] for k in ("conv_w", "A_log", "D", "dt_bias")}
    conv_buf, state = cache or (None, None)
    with Launches(ops) as run:
        parts = [ssm._core(cfg, zxbcdt, core, r * half, half, conv_buf,
                           None if state is None else state[:, r * half:(r + 1) * half], kernel=True) for r in range(2)]
    gated = [y * torch.nn.functional.silu(z.float()).to(h.dtype) for y, z, _, _ in parts]
    sumsq = sum(torch.sum(torch.square(g.float()), dim=-1, keepdim=True) for g in gated)  # the all-reduce
    out = 0
    for r, g in enumerate(gated):
        rows = slice(r * half * hd, (r + 1) * half * hd)
        normed = (g.float() * torch.rsqrt(sumsq / di + 1e-6) * p["gate_norm_w"][rows].float()).to(h.dtype)
        out = out + linear(normed, {"w": p["out_proj"][rows]},
                           {"a": lo["out_proj"]["a"][rows], "b": lo["out_proj"]["b"]}, scale)
    return out, parts[0][2], torch.cat([st for *_, st in parts], dim=1), run.counts


def attention_halves(ops, q, k, v, causal, wo, lo_wo, scale):
    """An attention and its out-projection as the two ranks of a (1, 2)
    mesh run them (``sharding_ctx.local_heads``): B8 over each rank's half
    of the heads, then each rank's rows of ``wo`` and of its LoRA ``a``, the
    partial outputs summed. Returns ``(the heads' outputs concatenated, the
    summed projection, B8's launches)``."""
    from repro_torch.models.layers import linear

    B, S, H, D = q.shape
    Hr, Kr = H // 2, k.shape[2] // 2
    with Launches(ops) as run:
        outs = [ops.flash_attention(q[:, :, r * Hr:(r + 1) * Hr], k[:, :, r * Kr:(r + 1) * Kr],
                                    v[:, :, r * Kr:(r + 1) * Kr], causal=causal, window=None) for r in range(2)]
    proj = sum(linear(o.reshape(B, S, Hr * D), {"w": wo[r * Hr * D:(r + 1) * Hr * D]},
                      {"a": lo_wo["a"][r * Hr * D:(r + 1) * Hr * D], "b": lo_wo["b"]}, scale)
               for r, o in enumerate(outs))
    return torch.cat(outs, dim=2), proj, run.counts


def phase_launch_heads(ops, smi, dev):
    """Phase o(ii): one layer of each kind of the three families at full
    width in f32 (2 layers; zamba2's shared block after every 2), its
    mixer and attentions run as each rank of a (1, 2) mesh runs them, one
    rank after the other on this card: B9 over nh / 2 heads, B8 over half
    the heads; recombined as DTensor recombines them and held to the whole
    layer. The steps' own collectives are not run here: gloo's functional
    all-gather of a CUDA tensor segfaults on torch 2.11, and NCCL takes
    one rank a device (``tests/test_torch_launch_mesh.py`` runs the mesh
    steps on gloo over CPU tensors). Returns the ranks' launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.models import encdec, ssm
    from repro_torch.models.layers import apply_rope, linear, rms_norm, sinusoidal_positions
    from repro_torch.models.transformer import _layer_slices, _norm, _project_qkv
    from repro_torch.utils.tree import tree_items, unflatten_dict

    counts = dict.fromkeys(LAUNCHED, 0)
    S = LAUNCH_SEQ

    def held(name, got, want, what, exact=False):
        err = float((got.float() - want.float()).abs().max())
        limit = 0.0 if exact else LAUNCH_HEADS_REL * float(want.float().abs().max())
        if not bool(torch.isfinite(got).all()) or err > limit:
            raise AssertionError(f"o(ii) {name}: the ranks' {what} recombined are {err:.3g} off the whole layer's "
                                 f"(limit {limit:.3g})")
        return err / max(limit, 1e-30)

    def add(run_counts):
        for k, v in run_counts.items():
            counts[k] += v

    for name, cut in LAUNCH_TP_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], dtype="float32", **cut)
        _, params, state, gen = train.init_run(cfg, dev, LAUNCH_GROUPS)
        # the GAL LoRA with b off zero, so each rank's LoRA term is live
        lora = unflatten_dict({k: torch.randn(v.shape, generator=gen, device=dev) * 0.01 if k.endswith("/b") else v
                               for k, v in tree_items(state["gal_lora"])})
        batch = train.random_batch(cfg, LAUNCH_PROMPTS, S, gen)
        scale = cfg.lora_alpha / cfg.lora_rank
        readings = {}
        with torch.no_grad():
            if cfg.ssm is not None:
                stack, lstack = (params["layers"], lora["layers"]) if cfg.family == "ssm" else \
                    (params["mamba"], lora["mamba"])
                p = {k: v[0] for k, v in stack.items()}
                lo = {t: {n: x[0] for n, x in ab.items()} for t, ab in lstack.items()}
                emb = torch.nn.functional.embedding(batch["tokens"], params["embed"])
                h = rms_norm(emb, p["norm_w"])
                out, window, st = ssm._mixer(h, p, cfg, lo, scale, kernel=True)
                got, got_window, got_st, run = mixer_halves(ops, ssm, cfg, h, p, lo, scale)
                if run != only(ssd_chunk_intra=2):
                    raise AssertionError(f"o(ii) {name}: the ranks' prefill scans did not take B9 once each: {run}")
                add(run)
                readings["prefill out"] = held(name, got, out, "prefill outputs")
                readings["prefill state"] = held(name, got_st, st, "final states")
                held(name, got_window, window, "conv windows", exact=True)
                h1 = rms_norm(torch.nn.functional.embedding(batch["tokens"][:, -1], params["embed"]), p["norm_w"])
                out1, window1, st1 = ssm._mixer(h1, p, cfg, lo, scale, kernel=False, cache=(window, st))
                got1, got_window1, got_st1, _ = mixer_halves(ops, ssm, cfg, h1, p, lo, scale, cache=(window, st))
                readings["decode out"] = held(name, got1, out1, "decode outputs")
                readings["decode state"] = held(name, got_st1, st1, "decode states")
                held(name, got_window1, window1, "decode conv windows", exact=True)
            attns = []
            if cfg.family == "hybrid":
                sp, sl = params["shared"], lora["shared"]
                x = rms_norm(emb, sp["attn_norm_w"])
                pos = torch.arange(S, device=dev)[None]
                qkv = [linear(x, {"w": sp[w]}, sl[w], scale).reshape(LAUNCH_PROMPTS, S, n, cfg.resolved_head_dim)
                       for w, n in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads), ("wv", cfg.num_kv_heads))]
                q, k = (apply_rope(t, pos, theta=cfg.rope_theta, mode="full") for t in qkv[:2])
                attns.append(("shared block", q, k, qkv[2], True, sp["wo"], sl["wo"]))
            if cfg.family == "audio":
                pe, le = _layer_slices(params["encoder"], lora["encoder"], 0)
                frames = batch["encoder_embeds"]
                xe = _norm(frames + sinusoidal_positions(frames.shape[1], cfg.d_model, frames.dtype, dev)[None], pe,
                           "attn_norm", "layernorm")
                attns.append(("encoder", *_project_qkv(xe, pe, le, cfg, scale), False, pe["wo"], le["wo"]))
                pd, ld = _layer_slices(params["decoder"], lora["decoder"], 0)
                xd = _norm(encdec._embed_tokens(params["decoder"], batch["tokens"], cfg), pd, "attn_norm",
                           "layernorm")
                attns.append(("decoder prompt", *_project_qkv(xd, pd, ld, cfg, scale), True, pd["wo"], ld["wo"]))
            for label, q, k, v, causal, wo, lo_wo in attns:
                o = ops.flash_attention(q, k, v, causal=causal, window=None)
                whole = linear(o.reshape(*o.shape[:2], -1), {"w": wo}, lo_wo, scale)
                heads, proj, run = attention_halves(ops, q, k, v, causal, wo, lo_wo, scale)
                if run != only(flash_attention=2):
                    raise AssertionError(f"o(ii) {name} {label}: the ranks' attentions did not take B8 once each: "
                                         f"{run}")
                add(run)
                held(name, heads, o, f"{label} attention heads", exact=True)
                readings[f"{label} out"] = held(name, proj, whole, f"{label} projections")
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim if cfg.ssm is not None else cfg.num_heads
        log(f"phase o(ii) {name} ({smi}), f32, the two ranks' bodies of a (1, 2) mesh on {nh // 2} of {nh} heads "
            f"each: recombined against the whole layer at {json.dumps({k: round(v, 4) for k, v in readings.items()})} "
            f"of the limit ({LAUNCH_HEADS_REL} of its largest |value|); heads and conv windows bit for bit; "
            f"{time.perf_counter() - t0:.1f} s")
        del params, state, lora, batch
        free_memory()
    return counts


def bit_equal(a, b, tree_leaves):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_resume(ops, make_runner, AsyncAggConfig, model, loss_fn, fl, clients, snaps, tree_leaves):
    """Phase l(i): phases 4, 5 and k(ii) resumed from their snapshots by
    fresh runners. Returns the launches."""
    t_phase = time.perf_counter()
    free_memory()
    args = ("fibecfed", model, loss_fn, fl, clients)
    launches = {"masked_adamw_update": 0, "masked_adamw_update_stacked": 0}

    # --- the loop and vectorized runs, bit for bit ---
    for name in ("loop", "vectorized"):
        s = snaps[name]
        res = resume(ops, make_runner, args, s, fl.rounds, engine=name, optimizer="adamw", fused_optimizer=True)
        r, hist = res["runner"], res["hist"]
        want = s["hist"][s["next_round"]:]
        losses = ([h["loss"] for h in hist], [h["loss"] for h in want])
        comm = (r.comm_bytes_per_round, r.comm_upload_bytes_per_round)
        diff, _ = lora_diffs(r.global_lora, s["global_lora"], tree_leaves)
        log(f"l(i) {name}: snapshot after round {s['next_round'] - 1}: {s['bytes']} bytes, saved in "
            f"{s['save_s']:.3f} s; restore {res['restore_s']:.3f} s; rounds after it {res['walls']} s; losses "
            f"{losses[0]} (uninterrupted {losses[1]}); comm bytes {comm[0]}; global LoRA max abs diff {diff}; "
            f"launches {res['counts']} over {res['steps']} steps")
        if losses[0] != losses[1] or comm != (s["comm"], s["upload"]) or \
                not bit_equal(r.global_lora, s["global_lora"], tree_leaves):
            raise AssertionError(f"l(i): the resumed {name} run is not the uninterrupted one bit for bit")
        if res["counts"] != only(masked_adamw_update=res["steps"]) or res["steps"] == 0:
            raise AssertionError(f"l(i): the resumed {name} run did not launch B1 once per step: {res['counts']}")
        launches["masked_adamw_update" + ("_stacked" if name == "vectorized" else "")] += res["steps"]
        del r, res
        free_memory()

    # --- the straggler run, accounting identical ---
    s = snaps["async"]
    res = resume(ops, make_runner, args, s, ASYNC_MERGES, engine="async", optimizer="adamw", fused_optimizer=True,
                 scenario="straggler", async_cfg=AsyncAggConfig(**STRAGGLER_POLICIES))
    r, hist = res["runner"], res["hist"]
    keys = ("virtual_time", "staleness_mean", "merged_clients", "dropped_clients", "stale_dropped", "buffer_size")
    got = [{k: h[k] for k in keys} for h in hist]
    want = [{k: h[k] for k in keys} for h in s["hist"][s["next_round"]:]]
    diff, excess = lora_diffs(r.global_lora, s["global_lora"], tree_leaves)
    log(f"l(i) async: snapshot after merge {s['next_round'] - 1} (in flight {s['in_flight']}, {s['heap_payloads']} "
        f"trained payloads on the heap, {s['buffered']} buffered): {s['bytes']} bytes, saved in {s['save_s']:.3f} s; "
        f"restore {res['restore_s']:.3f} s; merges after it {res['walls']} s; accounting {got}; losses "
        f"{[h['loss'] for h in hist]} (uninterrupted {[h['loss'] for h in s['hist'][s['next_round']:]]}); global "
        f"LoRA largest diff {diff:.3g} (excess over atol {ASYNC_RESUME_ATOL} + rtol {ASYNC_RESUME_RTOL}: "
        f"{excess:.3g}); launches {res['counts']} over {res['steps']} steps")
    if got != want or (r.comm_bytes_per_round, r.comm_upload_bytes_per_round) != (s["comm"], s["upload"]):
        raise AssertionError("l(i): the resumed async run's accounting differs from the uninterrupted one")
    if excess > 0:
        raise AssertionError("l(i): the resumed async run's global LoRA is beyond atol 5e-5 / rtol 1e-4")
    if res["counts"] != only(masked_adamw_update=res["steps"]) or res["steps"] == 0:
        raise AssertionError(f"l(i): the resumed async run did not launch B1 once per step: {res['counts']}")
    launches["masked_adamw_update"] += res["steps"]
    del r, res
    free_memory()
    log(f"phase l(i): {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_out_of_core(ops, make_runner, model, loss_fn, fl, clients, snaps, ckpt_root, tree_leaves):
    """Phase l(ii): phase 5's configuration through the service on an
    out-of-core store, its round 1 again from the service's snapshot, and
    its in-memory twin. Returns the launches."""
    from repro_torch.checkpoint import restore_runner
    from repro_torch.federated import FederationService, OutOfCoreStore
    from repro_torch.obs import Telemetry

    t_phase = time.perf_counter()
    free_memory()
    args = ("fibecfed", model, loss_fn, fl, clients)
    s5 = snaps["vectorized"]
    torch.cuda.reset_peak_memory_stats()
    store = OutOfCoreStore(os.path.join(ckpt_root, "ooc_store"), hot_slots=OOC_HOT_SLOTS)
    tel = Telemetry(run_id="l(ii)")
    with Launches(ops) as run:
        r = make_runner(*args, optimizer="adamw", fused_optimizer=True, seed=0, store=store, telemetry=tel)
        svc = FederationService()
        fed = svc.launch("ooc", r, rounds=fl.rounds, ckpt_dir=os.path.join(ckpt_root, "ooc"), ckpt_every=1)
        ticks = [timed(svc.tick)[1] for _ in range(fl.rounds)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    spans = {n: [round(e["dur"], 3) for e in tel.tracer.events if e["type"] == "span" and e["name"] == n]
             for n in ("init_phase", "difficulty", "sensitivity", "fim_warmup", "round", "store_fetch", "store_evict",
                       "store_flush")}
    counters = {k: v for k, v in tel.snapshot()["counters"].items() if k.startswith("store.")}
    hist = fed.history
    loss_rel = [abs(h["loss"] - w["loss"]) / abs(w["loss"]) for h, w in zip(hist, s5["hist"])]
    dis = [engine_disagreement(gv, go, g0) for gv, go, g0 in
           zip(tree_leaves(s5["global_lora"]), tree_leaves(r.global_lora), tree_leaves(s5["init_lora"]))]
    cold = sorted(f for f in os.listdir(store.directory) if f.endswith(".npz"))
    same_orders = all(np.array_equal(a, c.order) for a, c in zip(s5["orders"], r.clients))
    steps = sum(int(h["padded_steps"]) for h in hist)
    same_decisions = (all(np.array_equal(a, c.order) for a, c in zip(snaps["loop"]["orders"], r.clients))
                      and np.array_equal(snaps["loop"]["gal_layers"], r.gal_layers))
    log(f"l(ii) out of core ({OOC_HOT_SLOTS} hot slots, cohort {fl.devices_per_round}): service ticks {ticks} s "
        f"(init_phase span {spans['init_phase']} s: difficulty {spans['difficulty']}, sensitivity "
        f"{spans['sensitivity']}, FIM warmup {spans['fim_warmup']}; rounds {spans['round']} s, with a snapshot each); "
        f"store spans fetch {len(spans['store_fetch'])} ({sum(spans['store_fetch']):.3f} s), evict {len(spans['store_evict'])} "
        f"({sum(spans['store_evict']):.3f} s), flush {spans['store_flush']} s; counters {counters}; peak "
        f"{peak:.2f} GiB (phase 5 in memory {s5['peak']:.2f} GiB); losses {[h['loss'] for h in hist]} against "
        f"phase 5's {[h['loss'] for h in s5['hist']]} (rel {[round(x, 6) for x in loss_rel]}, limit "
        f"{ENGINE_LOSS_RTOL}); curriculum orders and GAL layers equal to phase 4's (the loop engine's): "
        f"{same_decisions}, orders equal to phase 5's: {same_orders}; global LoRA against phase 5's per leaf "
        f"(fraction disagreeing, max diff / largest update; held only where the orders agree): "
        f"{[(round(f, 6), round(m, 6)) for f, m in dis]}; cold files {cold}; launches {run.counts} over {steps} "
        f"padded steps")
    if fed.state != "completed" or (r.comm_bytes_per_round, r.comm_upload_bytes_per_round) != \
            (s5["comm"], s5["upload"]):
        raise AssertionError(f"l(ii): comm bytes {r.comm_bytes_per_round} differ from phase 5's {s5['comm']}")
    if not same_decisions or max(loss_rel) > ENGINE_LOSS_RTOL:
        raise AssertionError("l(ii): the out-of-core run's decisions or losses disagree with phases 4 and 5")
    if same_orders and (max(f for f, _ in dis) > ENGINE_AGREE_FRAC or max(m for _, m in dis) > 2.0):
        raise AssertionError("l(ii): the out-of-core run's global disagrees with phase 5's in-memory run")
    if cold != sorted(f"client_{ci}.npz" for ci in range(len(clients))):
        raise AssertionError(f"l(ii): cold files {cold}, not one for every client")
    if run.counts != only(masked_adamw_update=steps) or steps == 0:
        raise AssertionError(f"l(ii): the out-of-core run did not launch B1 once per step: {run.counts}")
    # round 1 again, from the service's snapshot, on a fresh store
    snap = dict(path=os.path.join(ckpt_root, "ooc", "round_00000001"), next_round=1)
    snap_bytes = dir_bytes(snap["path"])
    res = resume(ops, make_runner, args, snap, fl.rounds, optimizer="adamw", fused_optimizer=True,
                 store=OutOfCoreStore(os.path.join(ckpt_root, "ooc_store_resumed"), hot_slots=OOC_HOT_SLOTS))
    rr = res["runner"]
    diff, _ = lora_diffs(rr.global_lora, r.global_lora, tree_leaves)
    n_cold = len(os.listdir(os.path.join(snap["path"], "store")))
    log(f"l(ii) round 1 from round_00000001 ({snap_bytes} bytes, {n_cold} hardlinked cold files): restore {res['restore_s']:.3f} s; round {res['walls']} s; loss "
        f"{res['hist'][0]['loss']} (service {hist[1]['loss']}); global LoRA max abs diff {diff}; launches "
        f"{res['counts']} over {res['steps']} steps")
    if res["hist"][0]["loss"] != hist[1]["loss"] or not bit_equal(rr.global_lora, r.global_lora, tree_leaves) or \
            rr.comm_bytes_per_round != r.comm_bytes_per_round:
        raise AssertionError("l(ii): round 1 from the service's snapshot is not the service's round 1 bit for bit")
    if res["counts"] != only(masked_adamw_update=res["steps"]):
        raise AssertionError(f"l(ii): the resumed round did not launch B1 once per step: {res['counts']}")
    # the in-memory twin: phase 5's configuration on the default store with
    # the out-of-core run's decisions, which it holds bit for bit
    orders, masks = [c.order.copy() for c in r.clients], [c.neuron_mask for c in r.clients]
    with Launches(ops) as twin_run:
        twin = make_runner(*args, optimizer="adamw", fused_optimizer=True, seed=0)
        # its init is phase 5's, the same world and settings: restored, not run again
        restore_runner(twin, snaps["vectorized_init"]["path"])
        adopt_decisions(twin, orders, masks, r.gal_layers)
        twin_hist = [twin.run_round(t) for t in range(fl.rounds)]
    twin_steps = sum(int(h["padded_steps"]) for h in twin_hist)
    diff, _ = lora_diffs(twin.global_lora, r.global_lora, tree_leaves)
    log(f"l(ii) the in-memory twin with the out-of-core decisions: losses {[h['loss'] for h in twin_hist]} (out of "
        f"core {[h['loss'] for h in hist]}); global LoRA max abs diff {diff}; launches {twin_run.counts} over "
        f"{twin_steps} padded steps")
    if [h["loss"] for h in twin_hist] != [h["loss"] for h in hist] or \
            not bit_equal(twin.global_lora, r.global_lora, tree_leaves) \
            or twin.comm_bytes_per_round != r.comm_bytes_per_round:
        raise AssertionError("l(ii): the out-of-core run is not its in-memory twin bit for bit")
    if twin_run.counts != only(masked_adamw_update=twin_steps):
        raise AssertionError(f"l(ii): the twin did not launch B1 once per step: {twin_run.counts}")
    launches = {"masked_adamw_update_stacked": steps + res["steps"] + twin_steps}
    del r, rr, res, svc, fed, store, tel, twin
    free_memory()
    log(f"phase l(ii): {time.perf_counter() - t_phase:.1f} s")
    return launches


def dir_bytes(path):
    """Bytes of the files under ``path`` (a snapshot's hardlinked cold files
    counted at their size)."""
    return sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files)


def take_snapshot(root, name, runner, next_round):
    """Save ``runner``'s run snapshot as ``root/name/round_<next_round>``,
    outside any timed window of the run it observes."""
    from repro_torch.checkpoint import save_run_checkpoint

    path, secs = timed(lambda: save_run_checkpoint(os.path.join(root, name), runner, next_round))
    return dict(path=path, next_round=next_round, save_s=secs, bytes=dir_bytes(path))


def keyword_world(vocab_size, data_mod, fl):
    task = data_mod.make_keyword_task(n_samples=256, seq_len=64, vocab_size=vocab_size, seed=0)
    parts = data_mod.dirichlet_partition(task.data["label"], fl.num_devices, fl.dirichlet_alpha, seed=0)
    return [{k: v[i] for k, v in task.data.items() if k != "label"} for i in parts]


def gal_values_per_leaf(cfg, lora, gal_layers):
    """Values of each LoRA leaf that lie in GAL layers, in the tree's leaf
    order: a stacked leaf (L, ...) counts its GAL layers' slices, an
    unstacked one (the hybrid's shared block, one logical layer) all of its
    values when its layer is a GAL layer."""
    from repro_torch.lora import lora_layer_index_tree
    from repro_torch.utils.tree import tree_leaves

    gal = np.asarray(gal_layers, bool)
    return [int(gal[ids.cpu().numpy().reshape(-1)].sum()) * (leaf.numel() // ids.numel())
            for leaf, ids in zip(tree_leaves(lora), tree_leaves(lora_layer_index_tree(cfg, lora)))]


def expected_comm_bytes(cfg, lora, gal_layers, chosen, compression=None, ranks=None):
    """(total, upload) wire bytes of a round, from the GAL mask: each chosen
    client pulls its rank's share of the GAL layers' f32 LoRA values raw and
    pushes them in the configured wire format."""
    from repro_torch.federated.compress import leaf_upload_bytes

    total = up = 0
    for ci in chosen:
        rank = cfg.lora_rank if ranks is None else ranks[ci]
        for values in gal_values_per_leaf(cfg, lora, gal_layers):
            n = values * rank // cfg.lora_rank
            u = leaf_upload_bytes(n, 4, compression)
            total += 4 * n + u
            up += u
    return total, up


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def only(**counts):
    """Expected launch counts of a path: those given, 0 for every other kernel."""
    return {**dict.fromkeys(LAUNCHED, 0), **counts}


B7_KERNELS = ("batched_sparse_lora_apply", "batched_sparse_lora_few_rows", "batched_sparse_lora_split")


def add_b7(counts, errs, s):
    """A serve run's B7 launches and largest errors by path (``serve_phase``'s
    result ``s``) added into a phase's totals."""
    for name, err in zip(B7_KERNELS, (s["b7_err"], s["few_err"], s["split_err"])):
        counts[name] += s["counts"][name]
        errs[name] = max(errs[name], err)


class Launches:
    """The kernels' launch counts over one path: zeroed on entry, read on exit."""

    def __init__(self, ops):
        self.fns = {name: (getattr(ops, fn), attr) for name, (fn, attr) in COUNTERS.items()}

    def __enter__(self):
        for fn, attr in self.fns.values():
            setattr(fn, attr, 0)
        return self

    def __exit__(self, *exc):
        self.counts = {name: getattr(fn, attr) for name, (fn, attr) in self.fns.items()}
        return False


def check_round(runner, cfg, stats, t, compression=None, ranks=None):
    if not math.isfinite(stats["loss"]):
        raise AssertionError(f"round {t} loss is not finite")
    want = expected_comm_bytes(cfg, runner.global_lora, runner.gal_layers, runner.last_round_info["chosen"],
                               compression, ranks)
    got = (runner.comm_bytes_per_round[-1], runner.comm_upload_bytes_per_round[-1])
    if got != want or not all(isinstance(b, int) for b in got):
        raise AssertionError(f"comm bytes {got} != {want} recomputed from the GAL mask")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import data as data_mod
    from repro_torch.checkpoint import restore_runner
    from repro_torch.config import FibecFedConfig
    from repro_torch.configs import ARCHS
    from repro_torch.federated import AsyncAggConfig, CompressionConfig, FedPrompt, make_runner
    from repro_torch.kernels import (build, compress, fisher_diag, flash_attention, masked_update, ops, ref,
                                     sparse_lora, ssd_chunk)
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.utils.tree import tree_clone, tree_leaves, tree_map

    full_f32()
    t_start = time.perf_counter()

    def done(phase):
        print(f"chip_smoke: phase {phase} done at {time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)

    # --- 1. device ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device:", kind, "|", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)

    # --- 2. build: one nvcc per source, all started at once; phases 3-5 need
    # only B1-B3, so the rest compile in the background until phase 5b ---
    t0 = time.perf_counter()
    sources = (masked_update, compress, fisher_diag, sparse_lora, flash_attention, ssd_chunk)
    pool = ThreadPoolExecutor(max_workers=len(sources))

    def compile_timed(module):
        start = time.perf_counter()
        report = build.compile_cuda(module.SOURCE)[1]
        return report, time.perf_counter() - start

    builds = {module: pool.submit(compile_timed, module) for module in sources}

    def built(*modules):
        """Wait for the modules' builds (a failed build raises here), load
        them, log each one's compile seconds and ptxas report."""
        for module in modules:
            report, secs = builds.pop(module).result()
            module.library()
            log(f"{Path(module.SOURCE).name}: compiled in {secs:.1f} s, ready {time.perf_counter() - t0:.1f} s "
                f"after the builds started\n" + "\n".join(ptxas_summary(report)))

    built(masked_update, compress)
    done("2")

    # --- 3. kernels against their plain versions, and their times ---
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(ops, ref, gen)
    errs.update(phase_stacked_kernels(ops, ref, gen))
    phase_sgd_trees(ops, ref, gen, tree_leaves, tree_map)
    phase_adamw_trees(ops, ref, gen, tree_leaves, tree_map)
    errs.update(phase_compress_kernel(ops, ref, gen, tree_map))
    times = phase_timing(ops, ref, gen, tree_leaves, tree_map)

    cfg, model, loss_fn, fl, clients = qwen2_world(ARCHS, FibecFedConfig, data_mod, build_model, make_loss_fn)
    log("clients' samples:", [len(c["tokens"]) for c in clients])
    launches = {name: 0 for name in KERNELS}
    # run snapshots taken by phases 4, 5 and k, restored in phases 7, k and l
    snaps, ckpt_dir = {}, tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    ckpt_root = ckpt_dir.name
    done("3")

    # --- 4. the loop engine at full width ---
    torch.cuda.reset_peak_memory_stats()
    with Launches(ops) as fib_run:
        runner = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                             fused_optimizer=True, engine="loop", seed=0)
        _, init_s = timed(runner.init_phase)
        log(f"loop fibecfed init_phase: {init_s:.2f} s; gal layers {np.flatnonzero(runner.gal_layers).tolist()}")
        snaps["loop_init"] = take_snapshot(ckpt_root, "loop_init", runner, 0)  # what phase 7 restores
        fib_steps = 0
        # what phase k holds its degenerate async run to
        loop = dict(stats=[], chosen=[], init_lora=tree_clone(runner._init_lora))
        for t in range(fl.rounds):
            stats, secs = timed(lambda: runner.run_round(t))
            fib_steps += int(runner.last_round_info["client_steps"].sum())
            log(f"loop fibecfed round {t}: {secs:.2f} s, {json.dumps(stats)}")
            check_round(runner, cfg, stats, t)
            loop["stats"].append(stats)
            loop["chosen"].append(runner.last_round_info["chosen"].copy())
            if t == 0:
                round0 = (stats["loss"], tree_clone(runner.global_lora))
                loop["global0"] = round0[1]
                loop["clients0"] = {int(ci): tree_clone(runner.clients[ci].lora)
                                    for ci in runner.last_round_info["chosen"]}
                snaps["loop"] = take_snapshot(ckpt_root, "loop", runner, 1)  # what phase l resumes
            if t == 1:
                loop["clients1"] = {int(ci): tree_clone(runner.clients[ci].lora)
                                    for ci in runner.last_round_info["chosen"]}
    fused_decisions = ([c.order.copy() for c in runner.clients], runner.gal_layers.copy())
    loop.update(orders=fused_decisions[0], gal_layers=fused_decisions[1], steps=fib_steps,
                comm=list(runner.comm_bytes_per_round), global_lora=tree_clone(runner.global_lora))
    snaps["loop"].update(hist=loop["stats"], comm=loop["comm"], upload=list(runner.comm_upload_bytes_per_round),
                         global_lora=loop["global_lora"], orders=loop["orders"], gal_layers=loop["gal_layers"])
    loop_difficulty = [c.difficulty.copy() for c in runner.clients]
    log(f"loop fibecfed peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del runner

    with Launches(ops) as fed_run:
        fed = make_runner("fedavg_lora", model, loss_fn, fl, clients, optimizer="sgd",
                          fused_optimizer=True, engine="loop", seed=0)
        _, fed_init_s = timed(fed.init_phase)
        stats, secs = timed(lambda: fed.run_round(0))
    log(f"loop fedavg_lora init_phase: {fed_init_s:.2f} s; round 0: {secs:.2f} s, {json.dumps(stats)}")
    check_round(fed, cfg, stats, 0)
    fed_steps = int(fed.last_round_info["client_steps"].sum())
    del fed
    log("launches, loop paths:", {"fibecfed": fib_run.counts, "fedavg_lora": fed_run.counts},
        "steps:", {"fibecfed": fib_steps, "fedavg_lora": fed_steps})
    if fib_run.counts != only(masked_adamw_update=fib_steps) or fib_steps == 0:
        raise AssertionError("the loop fibecfed run did not launch the AdamW kernel once per step")
    if fed_run.counts != only(masked_sgd_update=fed_steps) or fed_steps == 0:
        raise AssertionError("the loop fedavg_lora run did not launch the SGD kernel once per step")
    launches["masked_adamw_update"] += fib_run.counts["masked_adamw_update"]
    launches["masked_sgd_update"] += fed_run.counts["masked_sgd_update"]
    done("4")

    # --- 5. the default path: the vectorized engine ---
    torch.cuda.reset_peak_memory_stats()
    with Launches(ops) as vec_run:
        vec = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                          fused_optimizer=True, seed=0)
        if vec.engine != "vectorized":
            raise AssertionError(f"the default engine is {vec.engine!r}")
        _, vec_init_s = timed(vec.init_phase)
        snaps["vectorized_init"] = take_snapshot(ckpt_root, "vectorized_init", vec, 0)  # what l(ii)'s twin restores
        log(f"vectorized fibecfed init_phase: {vec_init_s:.2f} s; "
            f"gal layers {np.flatnonzero(vec.gal_layers).tolist()}")
        gap, swaps, spread = difficulty_gap(loop_difficulty, [c.difficulty for c in vec.clients])
        log(f"vectorized vs loop Fisher difficulty per batch: largest relative gap {gap:.4g} "
            f"(limit {DIFFICULTY_RTOL}); {swaps} batch pairs ordered differently, their loop "
            f"scores at most {spread:.4g} apart (relative)")
        if gap > DIFFICULTY_RTOL or spread > 2 * gap:
            raise AssertionError("the vectorized difficulty scores disagree with the loop engine's")
        vec_steps, vec_hist = 0, []
        for t in range(fl.rounds):
            stats, secs = timed(lambda: vec.run_round(t))
            vec_steps += int(stats["padded_steps"])
            vec_hist.append(stats)
            log(f"vectorized fibecfed round {t}: {secs:.2f} s, {json.dumps(stats)}")
            check_round(vec, cfg, stats, t)
            if t == 0:
                vec_round0 = (stats, list(vec.comm_bytes_per_round), tree_clone(vec.global_lora))
                snaps["vectorized"] = take_snapshot(ckpt_root, "vectorized", vec, 1)  # what phase l resumes
    sharded_refs = {"vectorized": run_record(vec, vec_hist, tree_clone)}  # what phase m holds its run to
    vec_round0 += (vec.gal_layers.copy(), [c.order.copy() for c in vec.clients])  # what phase 5e holds its run to
    same = all(np.array_equal(a, c.order) for a, c in zip(fused_decisions[0], vec.clients))
    log(f"vectorized curriculum orders equal to the loop engine's: {same}; GAL layers equal: "
        f"{np.array_equal(fused_decisions[1], vec.gal_layers)}")
    snaps["vectorized"].update(hist=vec_hist, comm=list(vec.comm_bytes_per_round),
                               orders=[c.order.copy() for c in vec.clients],
                               upload=list(vec.comm_upload_bytes_per_round), global_lora=tree_clone(vec.global_lora),
                               init_lora=tree_clone(vec._init_lora), peak=torch.cuda.max_memory_allocated() / 2**30)
    log(f"vectorized fibecfed peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {vec_run.counts} over {vec_steps} padded steps")
    if vec_run.counts != only(masked_adamw_update=vec_steps) or vec_steps == 0:
        raise AssertionError("the vectorized run did not launch the AdamW kernel once per step")
    launches["masked_adamw_update_stacked"] += vec_run.counts["masked_adamw_update"]
    done("5")

    # --- 5b. the public kernel entry point on the vectorized run's data ---
    built(fisher_diag, sparse_lora, flash_attention, ssd_chunk)
    pool.shutdown()
    done("2 (the background builds)")
    ops_counts, ops_errs = phase_ops(ops, ref, sparse_lora, vec, cfg, gen, tree_leaves, tree_map)
    for name in ops_counts:
        launches[name] += ops_counts[name]
    errs.update(ops_errs)
    times.update(phase_ops_timing(ops, ref, fisher_diag, sparse_lora, vec, cfg, gen, tree_leaves, tree_map))
    done("5b")

    # --- 5c. attention (B8) and the SSD intra-chunk scan (B9) ---
    attn_counts, attn_errs, cases, ssd = phase_attention_ssd(ops, ref, flash_attention, ssd_chunk, vec, cfg, gen)
    for name in attn_counts:
        launches[name] += attn_counts[name]
    errs.update(attn_errs)
    times.update(phase_attention_ssd_timing(ops, ref, flash_attention, ssd_chunk, cases, ssd))
    del cases, ssd
    done("5c")

    # --- 5d. serving at full width: B8 on prefill, B7 on the per-slot LoRA ---
    serve_counts, serve_errs, serve_times = phase_serve(ops, ref, sparse_lora, flash_attention, vec, cfg, model)
    for name, n in serve_counts.items():
        launches[name] += n
        errs[name] = max(errs[name], serve_errs[name])
    b7_prefill_times(times, "serve_prefill", serve_times["b7_prefill"])
    times["batched_sparse_lora_few_rows"] = {k: v for k, v in serve_times["b7_decode"].items() if k != "max_abs_err"}
    times["flash_attention"]["serve_prefill"] = serve_times["b8_prefill"]
    del vec
    done("5d")

    # --- n. the launch layer: the FibecFed train step (B1 twice a step)
    # held to its B1-plain twin, the prefill (B8) and decode steps against
    # the training forward, one step profiled and set against its roofline ---
    launch_counts, b8_err = phase_launch(ops, ref, smi, tree_clone, tree_leaves)
    for name, n in launch_counts.items():
        launches[name] += n
    errs["flash_attention"] = max(errs["flash_attention"], b8_err)
    done("n")

    # --- o. the launch layer's steps for mamba2, zamba2 and whisper: (i) at
    # full width without a mesh, (ii) one layer of each kind as the ranks
    # of a (1, 2) mesh run it, each on its half of the heads ---
    t_o = time.perf_counter()
    dev = torch.device("cuda")
    family_counts, b8_err = phase_launch_families(ops, ref, smi, tree_clone, tree_leaves, dev)
    errs["flash_attention"] = max(errs["flash_attention"], b8_err)
    for name, n in family_counts.items():
        launches[name] += n
    for name, n in phase_launch_heads(ops, smi, dev).items():
        launches[name] += n
    log(f"phase o: {time.perf_counter() - t_o:.1f} s")
    done("o")

    # --- f. the Mamba2 family at full width: training, then serving (B9 on
    # the prefill scan, B7 on the per-slot LoRA of in_proj/out_proj) ---
    ssm_counts, ssm_errs, ssm_times = phase_ssm(ops, ref, sparse_lora, ssd_chunk, make_runner, data_mod,
                                                FibecFedConfig, ARCHS, build_model, make_loss_fn)
    for name, n in ssm_counts.items():
        launches[name] += n
    for name, e in ssm_errs.items():
        errs[name] = max(errs[name], e)
    times["ssd_chunk_intra"]["ssm_serve_prefill"] = ssm_times["b9_prefill"]
    b7_prefill_times(times, "ssm_serve_prefill", ssm_times["b7_prefill"])
    times["batched_sparse_lora_few_rows"]["ssm_serve_decode"] = ssm_times["b7_decode"]
    done("f")

    # --- h. the rest of the dense family: qwen3-0.6b trained and served,
    # stablelm-3b (B8 at D 80) and chatglm3-6b served, FedPrompt ---
    dense_counts, dense_errs, dense_times = phase_dense_family(
        ops, ref, sparse_lora, flash_attention, make_runner, data_mod, FibecFedConfig, ARCHS, build_model,
        make_loss_fn, FedPrompt)
    for name, n in dense_counts.items():
        launches[name] += n
    for name, e in dense_errs.items():
        errs[name] = max(errs[name], e)
    for name in ("qwen3-0.6b", "stablelm-3b", "chatglm3-6b"):
        times["batched_sparse_lora_few_rows"][f"{name}_serve_decode"] = dense_times[name]["b7_decode"]
        b7_prefill_times(times, f"{name}_serve_prefill", dense_times[name]["b7_prefill"])
    times["flash_attention"]["qwen3-0.6b_serve_prefill"] = dense_times["qwen3-0.6b"]["b8_prefill"]
    times["flash_attention"]["chatglm3-6b_serve_prefill"] = dense_times["chatglm3-6b"]["b8_prefill"]
    times["flash_attention_d80"]["stablelm-3b_serve_prefill"] = dense_times["stablelm-3b"]["b8_prefill"]
    log("phase h times:", json.dumps(dense_times))
    done("h")

    # --- i. the MoE family (granite-moe-3b-a800m trained and served,
    # llama4-maverick-400b-a17b served at one layer) and the zamba2 hybrid
    # (served at 15 layers: B9, B8 at D 112 and B7 on one path; trained at
    # 12 layers over the unstacked shared group) ---
    mh_counts, mh_errs, mh_times = phase_moe_hybrid(
        ops, ref, sparse_lora, flash_attention, ssd_chunk, make_runner, data_mod, FibecFedConfig, ARCHS, build_model,
        make_loss_fn)
    for name, n in mh_counts.items():
        launches[name] += n
    for name, e in mh_errs.items():
        errs[name] = max(errs[name], e)
    for name in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "zamba2-7b"):
        times["batched_sparse_lora_few_rows"][f"{name}_serve_decode"] = mh_times[name]["b7_decode"]
        b7_prefill_times(times, f"{name}_serve_prefill", mh_times[name]["b7_prefill"])
    times["flash_attention"]["granite-moe-3b-a800m_serve_prefill"] = mh_times["granite-moe-3b-a800m"]["b8_prefill"]
    times["flash_attention"]["llama4-maverick-400b-a17b_serve_prefill"] = \
        mh_times["llama4-maverick-400b-a17b"]["b8_prefill"]
    times["flash_attention_d112"]["zamba2-7b_serve_prefill"] = mh_times["zamba2-7b"]["b8_prefill"]
    log("phase i times:", json.dumps(mh_times))
    done("i")

    # --- j. the last families: whisper-large-v3 (B8 bidirectional on the
    # encoder, causal on the prompt, B7 on both LoRA groups) and paligemma-3b
    # (B8 at D 256) served and trained at a cut depth; roberta-large trained ---
    last_counts, last_errs, last_times = phase_last_families(
        ops, ref, sparse_lora, flash_attention, make_runner, data_mod, FibecFedConfig, ARCHS, build_model,
        make_loss_fn)
    for name, n in last_counts.items():
        launches[name] += n
    for name, e in last_errs.items():
        errs[name] = max(errs[name], e)
    for name in ("whisper-large-v3", "paligemma-3b"):
        times["batched_sparse_lora_few_rows"][f"{name}_serve_decode"] = last_times[name]["b7_decode"]
        b7_prefill_times(times, f"{name}_serve_prefill", last_times[name]["b7_prefill"])
    times["flash_attention"]["whisper-large-v3_serve_prefill"] = last_times["whisper-large-v3"]["b8_prefill"]
    times["flash_attention"]["whisper-large-v3_serve_encoder"] = last_times["whisper-large-v3"]["b8_encoder"]
    times["flash_attention_d256"]["paligemma-3b_serve_prefill"] = last_times["paligemma-3b"]["b8_prefill"]
    log("phase j times:", json.dumps(last_times))
    decode = {"qwen2-0.5b (5d)": serve_times, "mamba2-1.3b (f)": ssm_times,
              **{f"{n} (h)": dense_times[n] for n in ("qwen3-0.6b", "stablelm-3b", "chatglm3-6b")},
              **{f"{n} (i)": mh_times[n] for n in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "zamba2-7b")},
              **{f"{n} (j)": last_times[n] for n in ("whisper-large-v3", "paligemma-3b")}}
    for name, t in decode.items():
        prof, b7 = t["profiles"]["decode"], t["b7_decode"]
        log(f"decode step, {name}: {t['decode_step_ms']:.2f} ms, busy {prof['busy_share']:.1%}, B7 "
            f"{prof['b7_share']:.1%} of {prof['kernel_ms']:.2f} ms of kernels; B7 few-row at its decode shape "
            f"{b7['graph_ms']:.4f} ms, the {b7.get('old_path')} kernel {b7.get('old_graph_ms')} ms")
    for name, t in decode.items():
        (key, prof), = [(k, p) for k, p in t["profiles"].items() if k.startswith("prefill")]
        b7 = t["b7_prefill"]
        log(f"{key}, {name}: B7 {prof['b7_share']:.1%}, B8 {prof['b8_share']:.1%} and B9 {prof['b9_share']:.1%} of "
            f"{prof['kernel_ms']:.2f} ms "
            f"of kernels; B7 {b7['path']} at "
            f"{b7['target']} {b7['rows']} rows {b7['graph_ms']:.4f} ms ({b7['bound_share']:.1%} of its bound), "
            f"the {b7.get('old_path')} kernel {b7.get('old_graph_ms')} ms, two bmm {b7['library_ms']:.4f} ms")
    done("j")

    # --- k and l(i) (the async engine; runs resumed from their snapshots)
    # check and time nothing on the device: a second process on this card
    # runs them from phase 4's records and the snapshots of phases 4 and 5,
    # beside 5e, 6, m, 7, g and l(ii), which check and time nothing either ---
    second = SecondProcess(ckpt_root, dict(loop=loop, snaps={k: snaps[k] for k in ("loop", "vectorized")}),
                           t_start)
    del loop

    # --- 5e. the runner's telemetry= changes no bit of a vectorized round ---
    phase_runner_telemetry(make_runner, model, loss_fn, fl, clients, vec_round0, tree_leaves)
    del vec_round0
    done("5e")

    # --- 6. compressed uploads and per-client ranks, on both engines ---
    comp = CompressionConfig(**COMPRESSION)
    runs = {}
    for engine in ("loop", "vectorized"):
        with Launches(ops) as run:
            r = make_runner(PHASE6_BASELINE, model, loss_fn, fl, clients, optimizer="sgd", fused_optimizer=True,
                            engine=engine, compression=comp, client_ranks=RANKS, seed=0)
            _, c_init_s = timed(r.init_phase)
            stats, secs = timed(lambda: r.run_round(0))
        log(f"{engine} compressed+ranks: init {c_init_s:.2f} s, round 0 {secs:.2f} s, {json.dumps(stats)}; "
            f"launches {run.counts}; comm bytes {r.comm_bytes_per_round}, upload {r.comm_upload_bytes_per_round}")
        check_round(r, cfg, stats, 0, comp, RANKS)
        chosen = r.last_round_info["chosen"]
        steps = int(stats["padded_steps"]) if engine == "vectorized" else int(r.last_round_info["client_steps"].sum())
        uploads = 1 if engine == "vectorized" else len(chosen)
        if run.counts != only(masked_sgd_update=steps, fake_compress=uploads):
            raise AssertionError(f"the {engine} compressed run did not go through its kernels: {run.counts}")
        launches["masked_sgd_update" + ("_stacked" if engine == "vectorized" else "")] += run.counts["masked_sgd_update"]
        launches["fake_compress"] += run.counts["fake_compress"]
        if engine == "vectorized":
            sharded_refs["compressed"] = run_record(r, [stats], tree_clone)
        # low-rank clients' beyond-rank components never moved: after one
        # round from the initial global, they hold their initial values
        for ci in chosen:
            rank = RANKS[ci]
            for name, ab in r.clients[ci].lora["layers"].items():
                a0, b0 = r._init_lora["layers"][name]["a"], r._init_lora["layers"][name]["b"]
                if not (torch.equal(ab["a"][..., rank:], a0[..., rank:])
                        and torch.equal(ab["b"][:, rank:], b0[:, rank:])):
                    raise AssertionError(f"{engine}: client {ci} (rank {rank}) moved beyond its rank in {name}")
        runs[engine] = (r, stats)
    (rl, sl), (rv, sv) = runs["loop"], runs["vectorized"]
    np.testing.assert_array_equal(rl.last_round_info["chosen"], rv.last_round_info["chosen"])
    if (rl.comm_bytes_per_round, rl.comm_upload_bytes_per_round) != \
            (rv.comm_bytes_per_round, rv.comm_upload_bytes_per_round):
        raise AssertionError("the engines' comm bytes differ")
    loss_rel = abs(sv["loss"] - sl["loss"]) / abs(sl["loss"])
    dis = [engine_disagreement(gl, gv, g0) for gl, gv, g0 in
           zip(tree_leaves(rl.global_lora), tree_leaves(rv.global_lora), tree_leaves(rl._init_lora))]
    log(f"loop vs vectorized compressed+ranks round: loss rel {loss_rel:.3g}; per leaf "
        f"(fraction disagreeing, max diff / largest update): {[(round(f, 6), round(m, 6)) for f, m in dis]}")
    if loss_rel > ENGINE_LOSS_RTOL or max(f for f, _ in dis) > ENGINE_AGREE_FRAC or max(m for _, m in dis) > 2.0:
        raise AssertionError("the engines' compressed rounds disagree")
    del rl, rv, runs
    done("6")

    # --- m. the sharded engine on a 1-rank NCCL group: phases 5 and 6 again,
    # bit for bit ---
    for name, n in phase_sharded(ops, make_runner, CompressionConfig, model, loss_fn, fl, clients, cfg, smi,
                                 sharded_refs, tree_clone, tree_leaves).items():
        launches[name] += n
    del sharded_refs
    done("m")

    # --- 7. fused against unfused, in situ: the unfused runner restores
    # phase 4's snapshot from after its init (the init runs no optimizer) ---
    plain = make_runner("fibecfed", model, loss_fn, fl, clients, optimizer="adamw",
                        fused_optimizer=False, engine="loop", seed=0)
    restore_runner(plain, snaps.pop("loop_init")["path"])
    for a, b in zip(fused_decisions[0], [c.order for c in plain.clients]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fused_decisions[1], plain.gal_layers)
    stats = plain.run_round(0)
    rel = abs(stats["loss"] - round0[0]) / abs(round0[0])
    lora_err = max((a - b).abs().max().item()
                   for a, b in zip(tree_leaves(plain.global_lora), tree_leaves(round0[1])))
    log(f"fused vs unfused loop round 0: loss {round0[0]} vs {stats['loss']} (rel {rel:.3g}); "
        f"global LoRA max abs diff {lora_err:.3g}")
    # the unfused update does the kernel's arithmetic in the same order, so
    # the two runs agree to float noise or a kernel is at fault
    if rel > 1e-6 or lora_err > 1e-6:
        raise AssertionError("fused and unfused runs disagree")
    del plain
    done("7")

    # --- g. the lossless criteria (gal_fraction = sparse_ratio = None) ---
    for name, n in phase_lossless(ops, make_runner, data_mod, FibecFedConfig, ARCHS, build_model,
                                  make_loss_fn).items():
        launches[name] += n
    done("g")

    # --- l(ii). phase 5 through the service on an out-of-core store ---
    for name, n in phase_out_of_core(ops, make_runner, model, loss_fn, fl, clients, snaps, ckpt_root,
                                     tree_leaves).items():
        launches[name] += n
    done("l(ii)")

    # --- k and l(i)'s launches, once their process has ended ---
    for name, n in second.join().items():
        launches[name] += n
    del snaps
    ckpt_dir.cleanup()

    # --- 8. kernel list, card, ok ---
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was launched no time on the main paths: {launches}")
    kernels = [
        dict(name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
             launches=launches[name], max_abs_err=errs[name], **times[name])
        for name, spec in KERNELS.items()
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases_k_l(state_path) -> int:
    """The second process: phases k and l(i) on phase 4's world, rebuilt as
    the first process built it, from the state it handed over; writes their
    launches beside the state."""
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: end with the first process
    state = torch.load(state_path, map_location="cuda", weights_only=False)
    if os.getppid() != state["parent"]:
        return 1
    from repro_torch import data as data_mod
    from repro_torch.config import FibecFedConfig
    from repro_torch.configs import ARCHS
    from repro_torch.federated import AsyncAggConfig, CompressionConfig, make_runner
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.utils.tree import tree_leaves

    full_f32()
    root, snaps = os.path.dirname(state_path), state["snaps"]
    cfg, model, loss_fn, fl, clients = qwen2_world(ARCHS, FibecFedConfig, data_mod, build_model, make_loss_fn)

    def done(phase):
        print(f"chip_smoke: phase {phase} done at {time.time() - state['since']:.1f} s", file=sys.stderr, flush=True)

    # --- k. the async engine on phase 4's world: the degenerate run against
    # the loop engine, stragglers, compression with derived ranks and edges ---
    launches = phase_async(ops, make_runner, AsyncAggConfig, CompressionConfig, model, loss_fn, fl, clients, cfg,
                           state["loop"], tree_leaves, snaps, root)
    done("k")
    # --- l(i). run checkpoints: phases 4, 5 and k(ii) resumed from their
    # snapshots ---
    for name, n in phase_resume(ops, make_runner, AsyncAggConfig, model, loss_fn, fl, clients, snaps,
                                tree_leaves).items():
        launches[name] = launches.get(name, 0) + n
    done("l(i)")
    with open(os.path.join(root, "phases_k_l.json"), "w") as f:
        json.dump(launches, f)
    return 0


if __name__ == "__main__":
    sys.exit(phases_k_l(sys.argv[2]) if sys.argv[1:2] == ["--phases-k-l"] else main())
