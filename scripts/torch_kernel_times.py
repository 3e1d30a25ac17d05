"""Device times of the SSD intra-chunk kernel (B9) and the single-adapter
LoRA product (B5/B6) at the main paths' widths, without the model.

Builds the two CUDA sources from the repository, checks each kernel against
its plain version at chip_smoke.py's tolerances, and times it with
chip_smoke.py's helpers: the device time from a CUDA graph of launches over
inputs larger than the L2, and the launcher's time (host checks and the
ctypes call). B9 runs at mamba2-1.3b's widths (1024 groups, f32 and bf16
inputs); B5 at 4096 bf16 rows of qwen2-0.5b's wq (K 896, N 896) and wk
(N 128) with rank 8, random weights and a rho 0.5 neuron mask, and B6 on
wq's kept columns. Prints each time beside its byte bound and, last, one
JSON line with every number. With ``--repeat n`` every case is timed n
times in turns, so that the spread within one card shows.

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
from repro_torch.kernels import build, ref, sparse_lora, ssd_chunk  # noqa: E402


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
    """B5 on wq and wk, B6 on wq's kept columns: 8 copies of x and y, more than the L2 holds."""
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    M, K, r, copies, scale = cs.OPS_ROWS[1], 896, 8, 8, 2.0
    cases = {}
    for target, N in (("wq", 896), ("wk", 128)):
        a, b = randn(K, r) * 0.05, randn(r, N) * 0.05
        keep = (torch.rand(N, generator=gen, device="cuda") < 0.5).float()
        kept = torch.nonzero(keep).reshape(-1)
        for kind, bb, mk in (("b5", b, keep), ("b6", b[:, kept].contiguous(), None)):
            if kind == "b6" and target == "wk":
                continue
            n = bb.shape[1]
            xs = [randn(M, K).bfloat16() for _ in range(copies)]
            ys = [torch.empty(M, n, dtype=torch.bfloat16, device="cuda") for _ in range(copies)]
            launch = lambda i=0, xs=xs, ys=ys, bb=bb, mk=mk: sparse_lora.sparse_lora_launch(  # noqa: E731
                ys[i % copies], xs[i % copies], a, bb, mk, scale=scale)
            launch()
            plain = (ref.sparse_lora_matmul_ref(xs[0], a, bb, mk, scale) if mk is not None
                     else ref.sparse_lora_matmul_packed_ref(xs[0], a, bb, scale))
            err = cs.check_lora(ys[0], plain, f"{kind} {target}")
            mask_bytes = 4 * N if mk is not None else 0
            bound = cs.bound_of(2 * M * K + 2 * M * n + 4 * (K * r + r * n) + mask_bytes,
                                2 * M * K * r + 2 * M * r * n)
            cases[f"{kind}_{target}"] = (launch, bound, err)
            stages = sparse_lora.resident_stages(K, n, r, torch.bfloat16)
            print(f"{kind} {target}: N {n}, ring depth {stages}", flush=True)
    return cases


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    for module in (ssd_chunk, sparse_lora):
        _, report = build.compile_cuda(module.SOURCE)
        print(f"{module.SOURCE.name}:\n" + "\n".join(cs.ptxas_summary(report)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {**ssd_cases(gen), **lora_cases(gen)}
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
