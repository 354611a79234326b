"""End-to-end serving driver of the PyTorch port: batched generation through
the SepBIT paged KV store (the paper's placement algorithm running as the
serving memory manager). The twin of ``examples/serve_paged.py``: the same
flags plus ``--device``, the same reduced-config model (random weights from
seed 0, not JAX's values), the same admission loop and request lengths, so
the same page accounting and compaction WA; nosep, then sepbit.

    PYTHONPATH=src python examples/serve_paged_torch.py [--arch stablelm-1.6b]
        [--requests 48] [--device cpu]

On CUDA the decode step's attention is the flash-decode kernel (K5), built
with nvcc at first use.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.serving import make_decode_fn, make_prefill_fn, request_traffic, serve_paged


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    prefill = make_prefill_fn(model, cfg)
    decode = make_decode_fn(model, cfg)
    lengths, prompts = request_traffic(args.requests, args.max_new, args.prompt_len, cfg.vocab)

    results = {}
    for policy in ("nosep", "sepbit"):
        cache = model.init_cache(args.max_batch, args.prompt_len + args.max_new + 8,
                                 device=device)
        st = serve_paged(prefill, decode, params, cache, prompts, lengths, policy=policy,
                         page_tokens=args.page_tokens)
        results[policy] = st["wa"]
        print(f"{policy:7s}: compaction WA={st['wa']:.3f} "
              f"gc_pages={st['gc_writes']} throughput={st['tokens'] / st['wall']:,.0f} tok/s")

    print(f"\nSepBIT cuts KV-compaction copy traffic by "
          f"{100 * (1 - results['sepbit'] / results['nosep']):.1f}% on this workload.")


if __name__ == "__main__":
    main()
