"""Device times of the SSD intra-chunk kernel (B9) and the LoRA products
(B5-B7) at the main paths' widths, without the model.

Builds the two CUDA sources from the repository, checks each kernel against
its plain version at chip_smoke.py's tolerances, and times it with
chip_smoke.py's helpers: the device time from a CUDA graph of launches over
inputs larger than the L2, and the launcher's time (host checks and the
ctypes call). B9 runs at mamba2-1.3b's widths (1024 groups, f32 and bf16
inputs); B5 at 4096 bf16 rows of qwen2-0.5b's wq (K 896, N 896) and wk
(N 128) with rank 8, random weights and a rho 0.5 neuron mask, B6 (the
whole call) at wq, and B7 over 8 wq-shaped adapters (rows at random,
skewed, all on one adapter, all out of range) and 64; B7's few-row path
beside the BGMV kernel at the decode shapes of the served configs (8 rows,
one adapter each, rank 8) and at 16-64 rows of qwen2-0.5b's wq over 8
adapters, and its split path beside BGMV at the served prefill shapes whose
adapters do not stage (one adapter a 1024-token prompt). Prints each time beside its byte bound and, last, one JSON line
with every number. With ``--repeat n`` every case is timed n times in
turns, so that the spread within one card shows.

    python3 scripts/torch_kernel_times.py [--repeat 3]
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, flash_attention, ref, sparse_lora, ssd_chunk  # noqa: E402


def ssd_cases(gen):
    """B9's launch, the bound of its inputs and a check against the plain version."""
    cases = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, a, b, c = cs.ssd_inputs(gen, dtype)
        y = torch.empty(x.shape, dtype=torch.float32, device="cuda")
        G, Q, hd = x.shape
        N = b.shape[-1]
        pairs = Q * (Q + 1) // 2
        bytes_moved = x.element_size() * G * Q * (hd + 2 * N) + a.element_size() * G * Q + 4 * G * Q * hd
        rate = cs.BF16_FLOPS_PER_S if dtype == torch.bfloat16 else cs.F32_FLOPS_PER_S
        bound = cs.bound_of(bytes_moved, G * (pairs * (2 * N + 2 * hd + 2) + Q), rate)
        launch = lambda _=0, y=y, x=x, a=a, b=b, c=c: ssd_chunk.ssd_chunk_launch(y, x, a, b, c)  # noqa: E731
        launch()
        terms = ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs())
        err = cs.check_ssd(y, ref.ssd_chunk_intra_ref(x, a, b, c), terms, a, f"B9 {name}")
        cases[f"ssd_{name}"] = (launch, bound, err)
    return cases


def lora_cases(gen):
    """B5 on wq and wk, B6 (the whole call) on wq, and B7 over 8 wq-shaped
    adapters and over 64: 8 copies of x and y, more than the L2 holds."""
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    M, K, r, copies, scale = cs.OPS_ROWS[1], 896, 8, 8, 2.0
    cases = {}
    for target, N in (("wq", 896), ("wk", 128)):
        a, b = randn(K, r) * 0.05, randn(r, N) * 0.05
        keep = (torch.rand(N, generator=gen, device="cuda") < 0.5).float()
        nk = int(keep.sum())
        for kind, packed in (("b5", False), ("b6", True)):
            if kind == "b6" and target == "wk":
                continue
            xs = [randn(M, K).bfloat16() for _ in range(copies)]
            ys = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _ in range(copies)]
            launch = lambda i=0, xs=xs, ys=ys, a=a, b=b, keep=keep, packed=packed: (  # noqa: E731
                sparse_lora.sparse_lora_launch(ys[i % copies], xs[i % copies], a, b, keep, scale=scale, packed=packed))
            launch()
            plain = (ref.sparse_lora_apply_packed_ref if packed else ref.sparse_lora_matmul_ref)(xs[0], a, b, keep,
                                                                                                 scale)
            err = cs.check_lora(ys[0], plain, f"{kind} {target}")
            n = nk if packed else N  # the columns whose b is read and multiplied
            bound = cs.bound_of(2 * M * K + 2 * M * N + 4 * (K * r + r * n + N), 2 * M * K * r + 2 * M * r * n)
            cases[f"{kind}_{target}"] = (launch, bound, err)
            print(f"{kind} {target}: N {N}, {nk} kept, ring depth "
                  f"{sparse_lora.resident_stages(K, N, r, torch.bfloat16)}", flush=True)
    N = 896
    # rows at random, skewed 3/4 to adapter 0, all on adapter 0 (the plan's
    # cost alone: every block has one adapter) and all out of range (the
    # plan and zero rows), over 8 adapters; at random over 64
    kinds = {"b7_a8": (8, "random"), "b7_a8_skewed": (8, "skewed"), "b7_a8_on0": (8, "on0"),
             "b7_a8_out": (8, "out"), "b7_a64": (64, "random")}
    for name, (A, kind) in kinds.items():
        a, b = randn(A, K, r) * 0.05, randn(A, r, N) * 0.05
        mask = (torch.rand(A, N, generator=gen, device="cuda") < 0.5).float()
        if kind == "random":
            idx = torch.randint(0, A, (M,), generator=gen, device="cuda")
        elif kind == "skewed":
            idx = cs.skewed_rows(gen, M, A)
        else:
            idx = torch.full((M,), 0 if kind == "on0" else -1, device="cuda")
        idx = idx.int()
        xs = [randn(M, K).bfloat16() for _ in range(copies)]
        ys = [torch.empty(M, N, dtype=torch.bfloat16, device="cuda") for _ in range(copies)]
        launch = lambda i=0, xs=xs, ys=ys, a=a, b=b, mask=mask, idx=idx: sparse_lora.sparse_lora_launch(  # noqa: E731
            ys[i % copies], xs[i % copies], a, b, mask, idx, scale=scale)
        launch()
        err = cs.check_lora(ys[0], ref.batched_sparse_lora_matmul_ref(xs[0], idx, a, b, mask, scale), name)
        # what this batch needs: x of the rows in range, the adapters they use,
        # idx, and all of y
        rows = int(((idx >= 0) & (idx < A)).sum())
        used = int(torch.unique(idx[(idx >= 0) & (idx < A)]).numel())
        bound = cs.bound_of(2 * rows * K + 2 * M * N + 4 * M + 4 * used * (K * r + r * N + N),
                            2 * rows * K * r + 2 * rows * r * N)
        cases[name] = (launch, bound, err)
        print(f"{name}: ring depth {sparse_lora.resident_stages(K, N, r, torch.bfloat16, adapters=A, rows=M)}",
              flush=True)
    return cases


# decode shapes: (name, K, N) of one LoRA target at 8 rows; then rows of
# qwen2-0.5b's wq over 8 adapters (below SGMV's 16 rows an adapter)
FEW_SHAPES = (("qwen2_wq", 896, 896), ("qwen2_wk", 896, 128), ("mamba2_in_proj", 2048, 8512),
              ("mamba2_out_proj", 4096, 2048), ("qwen3_wq", 1024, 2048), ("stablelm_wq", 2560, 2560),
              ("chatglm3_wq", 4096, 4096))
FEW_ROWS = ((16, 8), (32, 8), (64, 8))
# served prefill shapes whose adapters do not stage for SGMV: (name, rows,
# K, N, adapters), one adapter a prompt of 1024 tokens
PREFILL_SHAPES = (("mamba2_in_proj", 4096, 2048, 8512, 4), ("mamba2_out_proj", 4096, 4096, 2048, 4),
                  ("zamba2_in_proj", 4096, 3584, 14576, 4), ("zamba2_out_proj", 4096, 7168, 3584, 4),
                  ("llama4_wq", 2048, 5120, 5120, 2), ("granite_wq", 4096, 1536, 1536, 4),
                  ("paligemma_wq", 4096, 2048, 2048, 4), ("stablelm_wq", 1024, 2560, 2560, 1),
                  ("chatglm3_wq", 1024, 4096, 4096, 1))


def path_cases(gen):
    """B7 where it takes the few-row path (decode shapes, up to 64 rows) or
    the split path (served prefills), each case named by the path its launch
    takes, beside the L2 (BGMV) kernel those launches took before
    (``bgmv_*``), on the same inputs (copies of x, y and the adapters: more
    than the L2 holds)."""
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    r, scale = 8, 2.0
    shapes = [(f"{name}_m8", 8, K, N, 8) for name, K, N in FEW_SHAPES]
    shapes += [(f"qwen2_wq_m{M}_a{A}", M, 896, 896, A) for M, A in FEW_ROWS]
    shapes += [(f"{name}_m{M}", M, K, N, A) for name, M, K, N, A in PREFILL_SHAPES]
    cases = {}
    for name, M, K, N, A in shapes:
        per_copy = 2 * M * (K + N) + 4 * A * (K * r + 2 * r * N)
        copies = max(2, min(16, int(4 * cs.L2_BYTES / per_copy)))
        path = sparse_lora.batched_path(M, K, N, r, torch.bfloat16, A)
        ins = []
        for _ in range(copies):
            a, b = randn(A, K, r) * 0.05, randn(A, r, N) * 0.05
            ins.append((randn(M, K).bfloat16(), a, b, torch.ones(A, N, device="cuda"),
                        torch.empty(M, N, dtype=torch.bfloat16, device="cuda")))
        # a decode step's rows one a slot; a prefill's slot-contiguous
        idx = (torch.arange(M, device="cuda") % A if M <= sparse_lora.FEW_MAX_ROWS
               else torch.arange(M, device="cuda") // (M // A)).int()
        for label in ({"few_rows": "few"}.get(path, path), "bgmv"):
            def launch(i=0, label=label, ins=ins, idx=idx, path=path):
                x, a, b, mask, y = ins[i % len(ins)]
                if label == "bgmv":
                    cs.forced_b7_launch(sparse_lora, y, x, idx, a, b, mask, scale)
                else:
                    assert sparse_lora.sparse_lora_launch(y, x, a, b, mask, idx, scale=scale) == path
            launch()
            x, a, b, mask, y = ins[0]
            err = cs.check_lora(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, scale), f"{name} {label}")
            bound = cs.bound_of(2 * M * K + 2 * M * N + 4 * M + 4 * A * (K * r + r * N + N),
                                2 * M * K * r + 2 * M * r * N)
            cases[f"{label}_{name}"] = (launch, bound, err)
    return cases


def flash_cases(gen):
    """B8 at stablelm-3b's head_dim 80 (32 heads, MHA) on a 4x1024 prefill,
    bf16 and f32, beside D 64 at the same shape."""
    cases = {}
    for name, D, dtype in (("d80_bf16", 80, torch.bfloat16), ("d64_bf16", 64, torch.bfloat16),
                           ("d80_f32", 80, torch.float32)):
        q, k, v = (torch.randn(4, 1024, 32, D, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out = torch.empty_like(q)
        launch = lambda _=0, q=q, k=k, v=v, out=out: flash_attention.flash_attention_launch(  # noqa: E731
            out, q, k, v, causal=True, window=8192)
        launch()
        err = cs.check_attention(out, ref.flash_attention_gqa_ref(q, k, v, causal=True, window=8192), v,
                                 f"B8 {name}")
        bound = cs.attention_bound(4, 1024, 32, 32, D, True, 8192, dtype)
        cases[f"flash_{name}"] = (launch, bound, err)
    return cases


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    for module in (ssd_chunk, sparse_lora, flash_attention):
        _, report = build.compile_cuda(module.SOURCE)
        print(f"{module.SOURCE.name}:\n" + "\n".join(cs.ptxas_summary(report)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {**ssd_cases(gen), **lora_cases(gen), **path_cases(gen), **flash_cases(gen)}
    torch.cuda.synchronize()
    results = {name: dict(max_abs_err=err, **bound, graph_ms=[], ms=[]) for name, (_, bound, err) in cases.items()}
    for _ in range(args.repeat):
        for name, (launch, _, _) in cases.items():
            results[name]["graph_ms"].append(cs.graph_ms(launch, calls=8, replays=5))
            results[name]["ms"].append(cs.cuda_ms(launch))
    for name, res in results.items():
        best = min(res["graph_ms"])
        res["bound_share"] = res["bound_ms"] / best
        print(f"{name}: device {res['graph_ms']} ms, {res['bound_share']:.1%} of its bound "
              f"({res['bound_ms']:.5f} ms); launcher {res['ms']} ms", flush=True)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
