"""End-to-end training driver of the PyTorch port, with fault tolerance: the
twin of ``examples/train_lm.py``, with the same flags plus ``--device``.

Trains a reduced-config LM (random weights from seed 0, not JAX's values)
on the synthetic pipeline, checkpointing through the SepBIT log-structured
blob store; ``--resume`` restarts from the latest manifest (kill it mid-run
and resume to see the crash path). Ends by printing the store's WA.

    PYTHONPATH=src python examples/train_lm_torch.py --arch phi3-mini-3.8b \\
        --steps 300 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]

Without ``--device`` it trains on ``cuda`` and raises where CUDA is missing.
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM, init_train_state,
                                  make_train_step)


def train(args, device):
    """Train ``args.steps`` steps on ``device``; returns every step's loss
    (read from the device once, at the end), the first step run and the
    store's WA."""
    device = resolve_device(device)
    cfg = smoke_config(args.arch)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    state = init_train_state(model, cfg, opt_cfg, torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(model, cfg, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    cm = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    if args.resume and cm.latest_step() is not None:
        state, manifest = cm.restore(state)
        start = manifest["step"] + 1
        print(f"resumed from step {manifest['step']}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        toks, labels = data.batch(step)
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(toks).to(device),
                                         "labels": torch.from_numpy(labels).to(device)})
        losses.append(metrics["loss"])
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} ({dt:.1f}s)")
        if step and step % args.ckpt_every == 0:
            cm.save(step, state, async_save=True)
    cm.save(args.steps - 1, state)
    cm.wait()
    wa = cm.store.write_amplification
    print(f"done; checkpoint-store WA={wa:.3f} (SepBIT-placed blobs)")
    return {"losses": [float(x) for x in losses], "start": start, "wa": wa}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train(args, device=args.device)


if __name__ == "__main__":
    main()
