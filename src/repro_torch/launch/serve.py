"""Serving launcher (the port of ``repro.launch.serve``): batched prefill,
then a decode loop, on the card, for any ``--arch``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --smoke --device cpu

The weights are random from ``--seed`` by the reference's init rules, drawn
with a ``torch.Generator`` (the reference uses ``PRNGKey(0)``, so the
weights differ); the prompt tokens, and the stub frontends' vision patch
and audio frame embeddings, come from ``np.random.default_rng(seed)`` in
the reference's order, so seed 0 gives the reference's inputs.  Times end
in a device synchronisation.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config, smoke_config
from ..device import resolve_device
from ..models import init as minit, model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="recurrentgemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator().manual_seed(args.seed)
    params = minit.init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    cache_len = args.prompt_len + args.gen + cfg.n_frontend_tokens
    dtype = minit.torch_dtype(cfg)

    def embeds(*shape):
        # float64 draws rounded once to the model's dtype, as jnp.asarray does
        return torch.as_tensor(rng.normal(size=shape) * 0.02).to(device, dtype)

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=device)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = embeds(args.batch, cfg.n_frontend_tokens,
                                       cfg.d_model)
    if cfg.frontend == "audio":
        batch = {"embeds": embeds(args.batch, args.prompt_len, cfg.d_model)}

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = M.prefill(params, cfg, batch, cache_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        pos = args.prompt_len + cfg.n_frontend_tokens
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, caches = M.decode_step(params, cfg, tok, pos, caches, cache_len)
            if args.temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / args.temperature, dim=-1)
                tok = torch.multinomial(probs.cpu(), 1, generator=gen).to(device)
            else:
                tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(tok)
            pos += 1
        toks = torch.cat(generated, dim=1)
        _sync(device)
        t_decode = time.perf_counter() - t0
    out = {
        "prefill_s": t_prefill,
        "decode_tok_per_s": args.batch * (args.gen - 1) / max(t_decode, 1e-9),
        "tokens": toks.cpu().numpy(),
    }
    print(f"arch={cfg.name} batch={args.batch}: prefill {t_prefill*1e3:.0f} ms, "
          f"decode {out['decode_tok_per_s']:.1f} tok/s")
    print("sample:", out["tokens"][0][:12])
    return out


if __name__ == "__main__":
    main()
