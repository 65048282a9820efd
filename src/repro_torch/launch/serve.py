"""Batched serving driver (port of ``src/repro/launch/serve.py``): prefill
a prompt batch into the KV/SSM caches, then decode token by token, greedy
or with temperature sampling, on random weights made from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 4 --prompt-len 1024 --gen 16

runs on the GPU (the RMSNorm, attention and scan kernels on); ``--smoke``
serves the registry's reduced variant, ``--device cpu`` runs on the CPU
(the kernels' plain versions). It prints the prefill time and the decode
rate beside the device they ran on (the card's name and power limit from
``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from .. import resolve_device
from ..configs import get_config, list_archs, smoke_variant
from ..configs.base import InputShape
from ..nn.modules import torch_dtype
from .steps import (StepOptions, init_serve_state, make_decode_step,
                    make_prefill_step)


def device_label(dev: torch.device) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit; "the CPU"
    on the CPU."""
    if dev.type != "cuda":
        return "the CPU"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(dev)} (power limit not read)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_img = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    opts = StepOptions(kv_chunk=max(64, args.prompt_len))
    state = init_serve_state(gen, cfg, InputShape(
        "serve", args.prompt_len + args.gen, args.batch, "prefill"))

    tok_shape = ((args.batch, args.prompt_len, cfg.n_codebooks)
                 if cfg.modality == "audio" else (args.batch, args.prompt_len))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, tok_shape,
                                     generator=gen, device=dev)}
    if cfg.modality == "vlm":
        batch["img"] = torch.randn(
            (args.batch, cfg.n_image_tokens, cfg.frontend_dim),
            generator=gen, device=dev, dtype=torch_dtype(cfg.dtype))
    prefill = make_prefill_step(cfg, opts)
    decode = make_decode_step(cfg, opts)
    label = device_label(dev)

    def sample(lg):
        if args.temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.to(torch.float32) / args.temperature, -1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=gen)
        return flat.reshape(probs.shape[:-1])

    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        state, logits = prefill(state, batch)
        sync(dev)
        t_prefill = time.perf_counter() - t0
        print(f"[serve] {cfg.name}: prefill B={args.batch} "
              f"S={args.prompt_len} in {t_prefill:.4f}s on {label}")
        tok = sample(logits)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            t_in = tok[:, None, :] if cfg.modality == "audio" else tok[:, None]
            state, logits = decode(state, {"tokens": t_in,
                                           "pos": args.prompt_len + n_img + i})
            tok = sample(logits)
            out.append(tok)
        sync(dev)
        dt = time.perf_counter() - t0
    n_tok = args.batch * (args.gen - 1)
    print(f"[serve] decoded {args.gen - 1} steps x batch {args.batch}: "
          f"{dt:.4f}s ({n_tok / max(dt, 1e-9):.1f} tok/s on {label})")
    toks = torch.stack(out, dim=1)
    print(f"[serve] sample tokens (client-private model output): "
          f"{toks[0].reshape(-1)[:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
