"""B8 (csrc/flash_attention.cu) in variants of its bf16 kernel's constants,
beside the parent commit's kernel, at phase 5c's bf16 shapes and two served
prefill shapes.

Each variant is a copy of the CUDA source with constants changed: the key
tile (``kBkNarrow`` at D 64-128, ``kBkWide`` at D 256), the K/V ring's
stages (``kStagesNarrow``), ping-pong off (``kPingPong``). The parent's
kernel is its source at ``HEAD`` (``git show``; where the checkout has no
git, as in a copy made for the card, pass ``--parent`` a file written
beforehand with ``git show HEAD:src/repro_torch/kernels/csrc/flash_attention.cu``).
Ablations (``--ablations``) take a part of the work out to show what it
costs: the lo product of p·v (``no_lo``), the softmax (``no_softmax``: p
is the raw score), or p·v altogether (``no_pv``); their outputs are wrong
by design, so they are timed and not checked. All are compiled in
parallel into ``build/attention_sweep/`` with ``kernels/build.py``'s flags
and loaded with ctypes. At each shape every other library is checked
against the plain version at ``chip_smoke.py``'s attention tolerance,
then all are timed in turns (device time from CUDA
graphs of launches, the best of ``--repeat`` turns), beside
``scaled_dot_product_attention`` and the bound (4·D flops a pair at the
bf16 peak, or the bytes). Prints each kernel's registers and spills from
``ptxas``, a table, and writes every time to ``--out`` (JSON).

    python3 scripts/torch_attention_sweep.py [--repeat 3] [--parent FILE] [--variants design,stages3] [--ablations]
                                             [--out build/attention_sweep/results.json]
"""
import argparse
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

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, flash_attention, ref  # noqa: E402

OUT = ROOT / "build" / "attention_sweep"
PARENT = "src/repro_torch/kernels/csrc/flash_attention.cu"
VARIANTS = {
    "design": {},
    "bk64": {"kBkNarrow": 64},
    "stages3": {"kStagesNarrow": 3},
    "no_pingpong": {"kPingPong": 0},
    "bk80_d256": {"kBkWide": 80},
}
# name -> the source's lines replaced (each must occur)
ABLATIONS = {
    "no_lo": [("      Wgmma<D>::rs(o, lo + 4 * kk, dv + ((kk * 16 * 128) >> 4), 1);\n", "")],
    "no_softmax": [("    softmax(t_lo * BK);\n", ""), ("      softmax((t_lo + i) * BK);\n", "")],
    "no_pv": [("      issue_pv(prev);\n", "      wgmma_commit();\n"), ("    issue_pv(last);\n", "    wgmma_commit();\n")],
}
# name -> (B, S, H, KVH, D, causal, window): phase 5c's bf16 cases, and the
# served prefill groups of qwen2-0.5b (4 x 1024) and llama4 (2 x 1024, D 128)
SHAPES = {
    "s4096_causal": (1, 4096, 14, 2, 64, True, None),
    "s16384_window8192": (1, 16384, 14, 2, 64, True, 8192),
    "d80_4x1024_window8192": (4, 1024, 32, 32, 80, True, 8192),
    "d112_4x1024_causal": (4, 1024, 32, 32, 112, True, None),
    "d256_4x1280_window8192": (4, 1280, 8, 1, 256, True, 8192),
    "whisper_encoder_4x1500_bidirectional": (4, 1500, 20, 20, 64, False, None),
    "roberta_4x512_bidirectional": (4, 512, 16, 16, 64, False, None),
    "qwen2_serve_4x1024": (4, 1024, 14, 2, 64, True, None),
    "llama4_serve_2x1024_d128": (2, 1024, 40, 8, 128, True, None),
}


def ablation_source(edits):
    src = flash_attention.SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def variant_source(consts):
    src = flash_attention.SOURCE.read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert n == 1, name
    return src


def parent_source(path):
    if path:
        return Path(path).read_text()
    return subprocess.run(["git", "show", f"HEAD:{PARENT}"], cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout


def build_all(sources):
    """Compile every source at once; returns name -> ctypes library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = OUT / f"{name}.cu"
        path.write_text(src)
        so = path.with_suffix(".so")
        procs[name] = (subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{report[-3000:]}")
        if "C7510" in report:  # wgmma serialized: the variant's pipeline is not what it claims
            print(f"{name}: ptxas serialized wgmma", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.repro_flash_attention.argtypes = flash_attention.library().repro_flash_attention.argtypes
        libs[name] = lib
        print(f"{name}: " + "; ".join(line.strip() for line in cs.ptxas_summary(report)
                                      if "flash_attention_tc_kernel" in line or "wgmma_kernel" in line), flush=True)
    return libs


def launcher(lib, out, q, k, v, causal, window):
    B, S, H, D = q.shape
    args = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, H, k.shape[2], D, int(causal),
            0 if window is None else min(window, S), 1, float(1.0 / D ** 0.5))

    def launch(_=0):
        err = lib.repro_flash_attention(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
    return launch


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--parent", default=None, help="the parent's flash_attention.cu (default: git show HEAD)")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--ablations", action="store_true", help="also time the ablations (not checked)")
    parser.add_argument("--out", default=str(OUT / "results.json"), help="where the JSON of every time goes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    names = args.variants.split(",")
    sources = {name: variant_source(VARIANTS[name]) for name in names}
    sources["parent"] = parent_source(args.parent)
    if args.ablations:
        sources.update({name: ablation_source(edits) for name, edits in ABLATIONS.items()})
    libs = build_all(sources)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, (B, S, H, KVH, D, causal, window) in SHAPES.items():
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, KVH, D, generator=gen, device="cuda").bfloat16() for _ in range(2))
        plain = cs.plain_attention(ref, q, k, v, causal, window)
        outs = {name: torch.empty_like(q) for name in libs}
        launches = {name: launcher(lib, outs[name], q, k, v, causal, window) for name, lib in libs.items()}
        errs = {}
        for name, launch in launches.items():
            launch()
            torch.cuda.synchronize()
            if name not in ABLATIONS:
                errs[name] = cs.check_attention(outs[name], plain, v, f"{name} {shape}")
        del plain
        big = S > 4096
        times = {name: [] for name in launches}
        for _ in range(args.repeat):
            for name, launch in launches.items():
                times[name].append(cs.graph_ms(launch, calls=2 if big else 5, replays=3))
        entry = dict(cs.attention_bound(B, S, H, KVH, D, causal, window, torch.bfloat16), shape=[B, S, H, KVH, D],
                     causal=causal, window=window, max_abs_err=errs, ms={n: min(t) for n, t in times.items()},
                     all_ms=times)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None or window >= S:
            entry["library_ms"] = cs.library_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True), big)
        else:
            entry["library_ms"] = cs.library_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), big)
            entry["library_is_causal_only"] = True
        results[shape] = entry
        row = "  ".join(f"{n} {entry['ms'][n]:.4f}" for n in launches)
        print(f"{shape}: bound {entry['bound_ms']:.4f} ({entry['bound_by']}); sdpa {entry['library_ms']}; {row}; "
              f"design {entry['bound_ms'] / entry['ms'].get('design', float('nan')):.1%} of its bound", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, results=results), indent=1))


if __name__ == "__main__":
    main()
