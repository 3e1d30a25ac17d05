"""Serving launcher: batched prefill and decode of random prompts.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --batch 4 --new-tokens 16

On the card (the default) it runs the full configuration; ``--device cpu``
runs the reduced one, as the JAX launcher does on one host device. The
weights are random, drawn from ``--seed``; a vlm's prefix and an
encoder-decoder's frames are zeros (``make_prompt_batch``). An encoder-only
model (roberta-large) has no decode path: the launcher exits with its
error.
"""
import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu runs the reduced configuration; default: the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.fibecfed import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, make_prompt_batch

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device)
    lora = model.init_lora(gen, device)
    batch = make_prompt_batch(cfg, args.seed, args.batch, args.prompt_len)
    engine = ServeEngine(model, params, lora, cache_len=args.prompt_len + args.new_tokens, device=device)
    t0 = time.perf_counter()
    try:
        res = engine.generate(batch, max_new_tokens=args.new_tokens, temperature=args.temperature,
                              seed=args.seed)
    except NotImplementedError as err:  # the encoder family: no decode path
        raise SystemExit(f"{args.arch}: {err}") from err
    dt = time.perf_counter() - t0
    print(f"{args.arch}: {res.steps} steps x batch {args.batch} in {dt:.1f}s on {device}")
    print(res.tokens)
    return res


if __name__ == "__main__":
    main()
