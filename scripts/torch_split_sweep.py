"""B7's split path (csrc/sparse_lora.cu) at the served prefill shapes, in
variants of its constants and with either launch left out.

Each variant is a copy of the CUDA source with one constant of the split
path changed (``kSplitStages``, ``kSplitXaBlocks``, ``kSplitYBlocks``,
``kSplitGroup``), or with the expand (``:shrink``) or the shrink
(``:expand``) not launched, so that each launch's share shows; all are
compiled in parallel into ``build/split_sweep/`` with ``kernels/build.py``'s
flags and loaded with ctypes. At each shape of
``scripts/torch_kernel_times.py``'s ``PREFILL_SHAPES`` (bf16 x, rank 8,
rows slot-contiguous) every full variant is checked against the plain
version, then every variant and the L2 kernel are timed in turns (CUDA
graphs, the best of three), beside the byte bound (x, y and the row index
once, each adapter's a, b and mask once).

    python3 scripts/torch_split_sweep.py
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_kernel_times as tkt  # noqa: E402
from repro_torch.kernels import build, ref, sparse_lora  # noqa: E402

OUT = ROOT / "build" / "split_sweep"
VARIANTS = {"design": {}, "stages2": {"kSplitStages": 2}, "xa_blocks2": {"kSplitXaBlocks": 2},
            "xa_blocks8": {"kSplitXaBlocks": 8}, "y_blocks2": {"kSplitYBlocks": 2},
            "y_blocks8": {"kSplitYBlocks": 8}, "group4": {"kSplitGroup": 4}}
ALONE = {  # the other launch left out
    "shrink": ("err = cudaLaunchKernelEx(&cfg, sparse_lora_split_y_kernel<T, RP>",
               "err = cudaSuccess; if (0) cudaLaunchKernelEx(&cfg, sparse_lora_split_y_kernel<T, RP>"),
    "expand": ("  sparse_lora_split_xa_kernel<T, RP><<<", "  if (0) sparse_lora_split_xa_kernel<T, RP><<<"),
}


def variant_source(consts, alone=None):
    src = sparse_lora.SOURCE.read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert n == 1, name
    if alone:
        old, new = ALONE[alone]
        assert src.count(old) == 1, alone
        src = src.replace(old, new)
    return src


def build_all(names):
    """Compile every variant at once; returns name -> ctypes library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        base, _, alone = name.partition(":")
        path = OUT / f"{name.replace(':', '_')}.cu"
        path.write_text(variant_source(VARIANTS[base], alone or None))
        so = path.with_suffix(".so")
        procs[name] = (subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{report[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.repro_sparse_lora.argtypes = sparse_lora.library().repro_sparse_lora.argtypes
        lib.repro_sparse_lora_path.argtypes = sparse_lora.library().repro_sparse_lora_path.argtypes
        libs[name] = lib
        print(f"{name}: " + "; ".join(line.strip() for line in cs.ptxas_summary(report)
                                      if "split" in line and "bfloat16Li8E" in line), flush=True)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(list(VARIANTS) + ["design:shrink", "design:expand"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, scale, results = 8, 2.0, {}
    for name, M, K, N, A in tkt.PREFILL_SHAPES:
        ins = []
        for _ in range(2):
            a, b = torch.randn(A, K, r, generator=gen, device="cuda") * 0.05, \
                torch.randn(A, r, N, generator=gen, device="cuda") * 0.05
            ins.append((torch.randn(M, K, generator=gen, device="cuda").bfloat16(), a, b,
                        torch.ones(A, N, device="cuda"), torch.empty(M, N, dtype=torch.bfloat16, device="cuda")))
        idx = (torch.arange(M, device="cuda") // (M // A)).int()
        bound = cs.bound_of(2 * M * K + 2 * M * N + 4 * M + 4 * A * (K * r + r * N + N),
                            2 * M * K * r + 2 * M * r * N)["bound_ms"]
        fns = {}
        for vname, lib in libs.items():
            floats = ctypes.c_int64(0)
            assert lib.repro_sparse_lora_path(M, K, N, r, A, 1, ctypes.byref(floats)) == 3  # the split path
            scratch = torch.empty(floats.value, device="cuda")

            def launch(i=0, lib=lib, scratch=scratch):
                x, a, b, mask, y = ins[i % 2]
                err = lib.repro_sparse_lora(y.data_ptr(), x.data_ptr(), idx.data_ptr(), a.data_ptr(), b.data_ptr(),
                                            mask.data_ptr(), None, scratch.data_ptr(), M, K, N, r, A, 1, 0, scale,
                                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{vname}: CUDA error {err}")
            launch()
            if ":" not in vname:
                x, a, b, mask, y = ins[0]
                cs.check_lora(y, ref.batched_sparse_lora_matmul_ref(x, idx, a, b, mask, scale), f"{name} {vname}")
            fns[vname] = launch
        fns["bgmv"] = lambda i=0: cs.forced_b7_launch(sparse_lora, ins[i % 2][4], ins[i % 2][0], idx, ins[i % 2][1],
                                                      ins[i % 2][2], ins[i % 2][3], scale)
        times = {k: [] for k in fns}
        for turn in range(3):
            for k, fn in (list(fns.items()) if turn % 2 == 0 else list(fns.items())[::-1]):
                times[k].append(cs.graph_ms(fn, calls=10, replays=5))
        results[name] = dict(rows=M, K=K, N=N, adapters=A, bound_ms=bound, **{k: min(v) for k, v in times.items()})
        print(f"{name} ({M} rows): bound {bound:.5f} ms; " + ", ".join(
            f"{k} {min(v):.4f} ({bound / min(v):.0%})" for k, v in times.items()), flush=True)
        del ins
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
