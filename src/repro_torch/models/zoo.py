"""Model facade of the port: one API over the architectures it runs (every
one but the vlm and audio stubs), the twin of the JAX package's
``models/zoo.py``.

    model  = build_model(cfg)               # raises for what is not ported
    specs  = model.param_specs()            # ParamSpec tree
    params = model.init_params(generator)   # on the generator's device
    logits, aux = model.forward(params, batch)
    cache  = model.init_cache(B, S, device=...)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, tokens, cache)

``batch`` is a dict with ``tokens`` (B, S). There is no sharder until
ROADMAP Queue 1 item 9.8.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from . import transformer
from .common import init_tree


@dataclasses.dataclass
class Model:
    cfg: object

    def param_specs(self):
        return transformer.lm_specs(self.cfg)

    def init_params(self, generator: torch.Generator):
        """Parameters of ``cfg.pdtype()`` on ``generator``'s device, drawn by
        the reference's rule (`common.make_param`); not JAX's values."""
        return init_tree(self.param_specs(), generator, self.cfg.pdtype())

    def forward(self, params, batch):
        return transformer.forward(self.cfg, params, batch["tokens"])

    def cache_specs(self, batch, max_seq):
        return transformer.cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch, max_seq, dtype=None, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_seq, dtype or self.cfg.cdtype(),
                                      resolve_device(device))

    def prefill(self, params, batch, cache):
        return transformer.prefill(self.cfg, params, batch["tokens"], cache)

    def decode_step(self, params, tokens, cache):
        return transformer.decode_step(self.cfg, params, tokens, cache)


def build_model(cfg) -> Model:
    """The model of ``cfg``; ``NotImplementedError`` naming the ROADMAP item
    for the families the port does not run yet (vlm, audio)."""
    transformer.check_supported(cfg)
    return Model(cfg)
