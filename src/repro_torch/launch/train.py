"""Training launcher (the port of ``repro.launch.train``): data pipeline ->
train_step -> checkpoint/restart, on the card.

Runs any ``--arch`` (full or ``--smoke`` reduced config) on one device.
Fault tolerance: periodic async checkpoints + automatic resume from the
latest step; ``--simulate-failure N`` raises a failure at step N once and
restores from the latest checkpoint, to exercise the restart path end to
end.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 30 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --device cpu --steps 30 --batch 4 --seq 32

The weights are random from the reference's init rules, drawn with
``torch.Generator().manual_seed(0)`` (the reference uses ``PRNGKey(0)``,
so the weights differ); the batches are the reference's ``SyntheticLM``
tokens, bit for bit.  The checkpoints go to ``--ckpt-dir`` (default
``repro_torch_ckpt`` in the system's temporary directory, apart from the
reference launcher's, so neither restores the other's run).  As the
reference does, a step reads its loss back to the host, and a logged
step its gradient norm; nothing else.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCH_NAMES, get_config, smoke_config
from ..data import DataConfig, SyntheticLM
from ..device import resolve_device
from ..distributed.fault_tolerance import HostFailure
from ..models import init as minit
from ..optim import AdamWConfig, init_state
from . import steps as S


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="inject a failure at this step once, then restore")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch
    ))

    def fresh():
        params = minit.init_params(cfg, torch.Generator().manual_seed(0), device)
        return params, init_state(params)

    params, opt_state = fresh()
    n_params = minit.param_count(cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq}")

    step_fn = S.make_train_step(cfg, opt_cfg)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    if args.resume and mgr.latest_step() is not None:
        params, opt_state = mgr.restore((params, opt_state))
        start = mgr.latest_step()
        print(f"resumed from step {start}")

    failed_once = False
    losses = []
    t0 = time.time()
    step = start
    while step < args.steps:
        try:
            if args.simulate_failure and step == args.simulate_failure and not failed_once:
                failed_once = True
                raise HostFailure(f"injected failure at step {step}")
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in data.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % args.log_every == 0:
                dt = (time.time() - t0) / max(1, len(losses))
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt*1e3:.0f} ms/step)", flush=True)
            step += 1
            if step % args.ckpt_every == 0:
                mgr.save(step, (params, opt_state))
        except HostFailure as e:
            print(f"FAILURE: {e}; restoring from latest checkpoint")
            mgr.wait()
            latest = mgr.latest_step()
            if latest is None:
                print("no checkpoint yet; restarting from scratch")
                step = 0
                params, opt_state = fresh()
            else:
                params, opt_state = mgr.restore((params, opt_state), latest)
                step = latest
                print(f"restored step {latest}")
    mgr.save(args.steps, (params, opt_state), blocking=True)
    mgr.wait()
    out = {
        "first_loss": losses[0] if losses else None,
        "last_loss": float(np.mean(losses[-10:])) if losses else None,
        "steps": args.steps,
    }
    print(f"done: first loss {out['first_loss']:.4f} -> "
          f"last-10 mean {out['last_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
