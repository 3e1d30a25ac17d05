"""B9 (csrc/ssd_chunk.cu) beside the parent commit's kernel, at phase 5c's
B9 shapes and mamba2-1.3b's serve prefill.

The parent's kernel is its source at ``HEAD`` (``git show``; where the
checkout has no git, as in a copy made for the card, pass ``--parent`` a
file written beforehand with
``git show HEAD:src/repro_torch/kernels/csrc/ssd_chunk.cu``). It is compiled
into ``build/ssd_sweep/`` with ``kernels/build.py``'s flags and loaded with
ctypes (its C entry takes contiguous (G, Q, hd) groups). At each shape both
kernels are checked against the plain version at ``chip_smoke.py``'s B9
tolerance, then timed in turns (device time from CUDA graphs of launches,
the best of ``--repeat`` turns) beside the bound (``chip_smoke.ssd_bound``).
At the serve prefill the design is also timed on the model's layout (x
(B, S, nh, hd) and b, c column slices of the conv's output, read in place:
``ops.ssd_chunk_intra_seq``), and the parent with the copies the model made
before its launch (x and the decays permuted into groups, b and c made
contiguous). ``--variants`` adds copies of the design's source with
constants changed (the f32 route's k-steps a wgmma group, ``kTf32Steps``),
compiled beside the parent and timed with it (f32 shapes only). Prints
each kernel's registers and spills from ``ptxas``, the design's launch
layout, a line a shape, and writes every time to ``--out`` (JSON).

    python3 scripts/torch_ssd_sweep.py [--repeat 3] [--parent FILE] [--variants tf32_steps4,tf32_steps8]
                                       [--out build/ssd_sweep/results.json]
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
from repro_torch.kernels import build, ops, ref, ssd_chunk  # noqa: E402

OUT = ROOT / "build" / "ssd_sweep"
PARENT = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
SERVE = dict(cs.SSD_SERVE, heads=cs.SSD_WIDTHS["nh"])  # mamba2-1.3b's serve prefill group: 4 prompts of 1024
VARIANTS = {"tf32_steps4": {"kTf32Steps": 4}, "tf32_steps8": {"kTf32Steps": 8}}
# name -> (dtype, ssd_inputs keywords): phase 5c's timed B9 cases and the serve prefill
SHAPES = {
    "f32": (torch.float32, {}),
    "bf16": (torch.bfloat16, {}),
    "zamba2_f32": (torch.float32, dict(B=cs.ZAMBA2_SSD["B"], S=cs.ZAMBA2_SSD["S"], heads=cs.ZAMBA2_SSD["nh"],
                                       widths=cs.ZAMBA2_SSD)),
    "zamba2_bf16": (torch.bfloat16, dict(B=cs.ZAMBA2_SSD["B"], S=cs.ZAMBA2_SSD["S"], heads=cs.ZAMBA2_SSD["nh"],
                                         widths=cs.ZAMBA2_SSD)),
    "serve_prefill_bf16": (torch.bfloat16, SERVE),
    "serve_prefill_f32": (torch.float32, SERVE),
}


def parent_source(path):
    if path:
        return Path(path).read_text()
    return subprocess.run(["git", "show", f"HEAD:{PARENT}"], cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout


def variant_source(consts):
    src = ssd_chunk.SOURCE.read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert n == 1, name
    return src


def build_all(sources):
    """Compile every source at once; returns name -> (ctypes library, ptxas report)."""
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
        lib = ctypes.CDLL(str(so))
        if name == "parent":
            lib.repro_ssd_chunk.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            lib.repro_ssd_chunk.argtypes = ssd_chunk.library().repro_ssd_chunk.argtypes
        lib.repro_ssd_chunk.restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def variant_launcher(lib, y, x, a, b, c, heads):
    """A variant of the design through its C entry, on the groups' layout."""
    G, Q, hd = x.shape
    R = G // heads
    xv, av, yv = x.view(R, heads, Q, hd), a.view(R, heads, Q), y.view(R, heads, Q, hd)
    strides = (ctypes.c_longlong * 13)(*xv.stride()[:3], *yv.stride()[:3], *av.stride(), *b.stride()[:2],
                                       *c.stride()[:2])
    args = (y.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), R, heads, Q, hd, b.shape[-1],
            ssd_chunk.DTYPE_CODES[x.dtype], ssd_chunk.DTYPE_CODES[a.dtype], ctypes.cast(strides, ctypes.c_void_p))

    def launch(_=0):
        err = lib.repro_ssd_chunk(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed with CUDA error {err}")
    return launch


def parent_launcher(lib, y, x, a, b, c, heads):
    G, Q, hd = x.shape
    args = (y.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), G, Q, hd, b.shape[-1], heads,
            ssd_chunk.DTYPE_CODES[x.dtype], ssd_chunk.DTYPE_CODES[a.dtype])

    def launch(_=0):
        err = lib.repro_ssd_chunk(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed with CUDA error {err}")
    return launch


def copies_then_parent(launch_parent, xs, a_s, bs, cs_, x, a, b, c, B, S, heads, Q):
    """What the model's prefill ran before this design: the permuted copies
    of x and the decays into groups, b and c made contiguous, then the
    parent's launch (writing into x, a, b and c's storage)."""
    nc, hd, N = S // Q, xs.shape[-1], bs.shape[-1]

    def run(_=0):
        x.copy_(xs.reshape(B, nc, Q, heads, hd).permute(0, 1, 3, 2, 4).reshape(B * nc * heads, Q, hd))
        a.copy_(a_s.reshape(B, nc, Q, heads).permute(0, 1, 3, 2).reshape(B * nc * heads, 1, Q))
        b.copy_(bs.reshape(B * nc, Q, N))
        c.copy_(cs_.reshape(B * nc, Q, N))
        launch_parent()
    return run


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--parent", default=None, help="the parent's ssd_chunk.cu (default: git show HEAD)")
    parser.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    parser.add_argument("--out", default=str(OUT / "results.json"), help="where the JSON of every time goes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    _, report = build.compile_cuda(ssd_chunk.SOURCE)
    ssd_chunk.library()
    sources = {"parent": parent_source(args.parent)}
    sources.update({name: variant_source(VARIANTS[name]) for name in filter(None, args.variants.split(","))})
    libs = build_all(sources)
    plib = libs["parent"][0]
    for name, rep in [("design", report)] + [(n, r) for n, (_, r) in libs.items()]:
        print(f"{name}: " + "; ".join(line.strip() for line in cs.ptxas_summary(rep)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, (dtype, kw) in SHAPES.items():
        x, a, b, c = cs.ssd_inputs(gen, dtype, **kw)
        heads = kw.get("heads", 1)
        G, Q, hd = x.shape
        lay = ssd_chunk.layout(dtype, G // heads, heads)
        plain = ref.ssd_chunk_intra_ref(x, a, b, c, heads)
        terms = ref.ssd_chunk_intra_ref(x.abs(), a, b.abs(), c.abs(), heads)
        y, yp = torch.empty(x.shape, device="cuda"), torch.empty(x.shape, device="cuda")
        launches = {"design": lambda _=0: ssd_chunk.ssd_chunk_launch(y, x, a, b, c, heads),
                    "parent": parent_launcher(plib, yp, x, a, b, c, heads)}
        outs = {}
        if dtype == torch.float32:  # the variants change the f32 route only
            outs = {name: torch.empty_like(y) for name in libs if name != "parent"}
            launches.update({name: variant_launcher(libs[name][0], out, x, a, b, c, heads)
                             for name, out in outs.items()})
        for launch in launches.values():
            launch()
        torch.cuda.synchronize()
        errs = {"design": cs.check_ssd(y, plain, terms, a, f"design {shape}"),
                "parent": cs.check_ssd(yp, plain, terms, a, f"parent {shape}")}
        for name, out in outs.items():  # the same sums in the same order: the design's bits
            if not torch.equal(out, y):
                raise AssertionError(f"{name} {shape}: other bits than the design's")
        del plain, terms
        if shape.startswith("serve_prefill"):
            B, S = kw["B"], kw["S"]
            xs, a_s, bs, cs_ = cs.ssd_model_layout(x, a, b, c, B, S, heads, Q)
            ys = ops.ssd_chunk_intra_seq(xs, a_s, bs, cs_, Q)
            torch.cuda.synchronize()
            want = y.reshape(B, S // Q, heads, Q, hd).permute(0, 1, 3, 2, 4).reshape(B, S, heads, hd)
            if not torch.equal(ys, want):
                raise AssertionError(f"{shape}: the model's layout gives other bits than the groups' layout")
            xg, ag, bg, cg = (torch.empty_like(t) for t in (x, a, b, c))
            launches["design_model_layout"] = lambda _=0: ops.ssd_chunk_intra_seq(xs, a_s, bs, cs_, Q)
            launches["parent_with_copies"] = copies_then_parent(parent_launcher(plib, yp, xg, ag, bg, cg, heads),
                                                                xs, a_s, bs, cs_, xg, ag, bg, cg, B, S, heads, Q)
        times = {name: [] for name in launches}
        for _ in range(args.repeat):
            for name, launch in launches.items():
                times[name].append(cs.graph_ms(launch, calls=5, replays=3))
        entry = dict(cs.ssd_bound(x, a, b, heads), shape=[G, Q, hd, b.shape[-1]], heads=heads,
                     dtype=str(dtype).split(".")[-1], layout=lay, max_abs_err=errs,
                     ms={n: min(t) for n, t in times.items()}, all_ms=times)
        entry["bound_share"] = {n: entry["bound_ms"] / t for n, t in entry["ms"].items()}
        results[shape] = entry
        row = "  ".join(f"{n} {t:.4f}" for n, t in entry["ms"].items())
        print(f"{shape} ({G} groups, heads {heads}, head block {lay['head_block']}, {lay['units']} units on "
              f"{lay['blocks']} blocks): bound {entry['bound_ms']:.4f} ({entry['bound_by']}); {row}; design "
              f"{entry['bound_share']['design']:.1%} of its bound, parent {entry['bound_share']['parent']:.1%}",
              flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, results=results), indent=1))


if __name__ == "__main__":
    main()
