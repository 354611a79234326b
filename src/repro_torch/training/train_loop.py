"""Train-step factory of the port: microbatched gradient accumulation and
AdamW on autograd, the twin of the JAX package's ``training/train_loop.py``.

``make_train_step`` returns ``step_fn(state, batch) -> (state, metrics)``:
the parameters and moments are updated in place, the metrics (``loss``,
``grad_norm``, ``lr``) are 0-d device tensors, and nothing is read from the
device. A ``sharder`` (``distributed.sharding.Sharder``) goes to the model's
forward, as the reference's does; on a multi-rank mesh the state and batch
are DTensors, placed by ``sharding.place_params``, the step runs under
``Sharder.scope``, and the gradients come back in the parameters'
placements (DTensor's backward reduces them across ranks).
"""

from __future__ import annotations

import torch

from ..distributed.sharding import scope
from ..models.common import constrain, tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def cross_entropy(logits, labels, ignore_index: int = -1, sharder=None):
    """Mean CE over non-ignored labels, with a float32 logsumexp."""
    logits = logits.to(torch.float32)
    mask = labels != ignore_index
    safe = labels.clamp(min=0).to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])
    # along a sharded vocabulary, a pending sum on each rank: reduced here
    ll = constrain(sharder, ll, "batch", "seq", None)[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1).to(torch.float32)


def make_loss_fn(model, cfg, sharder=None):
    def loss_fn(params, batch):
        with scope(sharder):
            logits, aux = model.forward(params, batch, sharder)
            labels = batch["labels"]
            logits = logits[:, -labels.shape[1]:]
            ce = cross_entropy(logits, labels, sharder=sharder)
            return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def loss_and_grads(loss_fn, params, batch, microbatches: int = 1):
    """(loss, grads) of ``loss_fn`` at ``params`` on ``batch``, the loss a
    detached 0-d tensor and the grads a tree shaped as ``params``. With
    ``microbatches = M > 1`` the batch is split in M along its first axis,
    the gradients summed in float32 and divided by M, and the loss is the
    mean of the M losses (the reference's ``lax.scan``); with M = 1 the
    gradients stay in the parameters' dtype (``jax.value_and_grad``'s).
    A parameter the loss does not use (the vlm family's ``vision_proj`` on a
    batch without a prefix) gets a zero gradient, as in JAX. Each parameter
    becomes a leaf that requires grad; its ``.grad`` is None afterwards."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    M = max(microbatches, 1)
    if M == 1:
        loss, _ = loss_fn(params, batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    else:
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        lsum = None
        for i in range(M):
            mb = {k: x.reshape((M, x.shape[0] // M) + x.shape[1:])[i] for k, x in batch.items()}
            part, _ = loss_fn(params, mb)
            part.backward()
            for a, p in zip(grads, leaves):
                if p.grad is not None:
                    a.add_(p.grad.to(torch.float32))
                p.grad = None
            part = part.detach()
            lsum = part if lsum is None else lsum + part
        n = torch.full((), M, dtype=torch.float32, device=lsum.device)
        grads = [a / n for a in grads]
        loss = lsum / n
    for p in leaves:
        p.grad = None
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, cfg, opt_cfg: AdamWConfig, sharder=None):
    """``step_fn(state, batch)`` for ``state = {"params", "opt"}`` and a batch
    of ``tokens`` and ``labels`` tensors: `loss_and_grads` over
    ``cfg.microbatches``, then `adamw_update` in place."""
    loss_fn = make_loss_fn(model, cfg, sharder)

    def step_fn(state, batch):
        params, opt = state["params"], state["opt"]
        with scope(sharder):
            loss, grads = loss_and_grads(loss_fn, params, batch, cfg.microbatches)
            _, new_opt, om = adamw_update(opt_cfg, params, grads, opt)
        return {"params": params, "opt": new_opt}, {"loss": loss, **om}

    return step_fn


def init_train_state(model, cfg, opt_cfg: AdamWConfig, generator: torch.Generator) -> dict:
    """Parameters from ``generator`` (on its device) and a fresh optimizer
    state."""
    params = model.init_params(generator)
    return {"params": params, "opt": init_opt_state(opt_cfg, params)}
