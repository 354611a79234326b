"""Model facade of the port: one API over the ten architectures, the twin of
the JAX package's ``models/zoo.py``.

    model  = build_model(cfg)
    specs  = model.param_specs()            # ParamSpec tree
    params = model.init_params(generator)   # on the generator's device
    logits, aux = model.forward(params, batch, sharder)
    cache  = model.init_cache(B, S, device=...)
    logits, cache = model.prefill(params, batch, cache, sharder)
    logits, cache = model.decode_step(params, tokens, cache, sharder)
    batch  = model.input_specs(shape, abstract=False, generator=g)

``batch`` is a dict: ``tokens`` (B, S) always; ``prefix`` (B, P, D) for the
vlm family and ``frames`` (B, T, D) for the audio family, the stub
frontends' embeddings. ``sharder`` (``distributed.sharding.Sharder``,
default None) puts the reference's sharding constraints in; on a
multi-rank mesh the parameters, caches and batch are DTensors
(``sharding.place_params``).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from . import transformer, whisper
from .common import init_tree


@dataclasses.dataclass
class Model:
    cfg: object

    @property
    def audio(self) -> bool:
        return self.cfg.family == "audio"

    def param_specs(self):
        if self.audio:
            return whisper.whisper_specs(self.cfg)
        return transformer.lm_specs(self.cfg)

    def init_params(self, generator: torch.Generator):
        """Parameters of ``cfg.pdtype()`` on ``generator``'s device, drawn by
        the reference's rule (`common.make_param`); not JAX's values."""
        return init_tree(self.param_specs(), generator, self.cfg.pdtype())

    def forward(self, params, batch, sharder=None):
        if self.audio:
            return whisper.forward(self.cfg, params, batch["frames"], batch["tokens"], sharder)
        return transformer.forward(self.cfg, params, batch["tokens"], sharder,
                                   prefix_embeds=batch.get("prefix"))

    def _stream_len(self, max_seq: int) -> int:
        """The vlm family's stream holds the image prefix and the text."""
        if self.cfg.family == "vlm":
            return max_seq + self.cfg.n_prefix_tokens
        return max_seq

    def cache_specs(self, batch, max_seq):
        if self.audio:
            return whisper.cache_specs(self.cfg, batch, max_seq)
        return transformer.cache_specs(self.cfg, batch, self._stream_len(max_seq))

    def init_cache(self, batch, max_seq, dtype=None, device="cuda"):
        dtype, device = dtype or self.cfg.cdtype(), resolve_device(device)
        if self.audio:
            return whisper.init_cache(self.cfg, batch, max_seq, dtype, device)
        return transformer.init_cache(self.cfg, batch, self._stream_len(max_seq), dtype, device)

    def prefill(self, params, batch, cache, sharder=None):
        if self.audio:
            return whisper.prefill(self.cfg, params, batch["frames"], batch["tokens"], cache,
                                   sharder)
        return transformer.prefill(self.cfg, params, batch["tokens"], cache, sharder,
                                   prefix_embeds=batch.get("prefix"))

    def decode_step(self, params, tokens, cache, sharder=None):
        if self.audio:
            return whisper.decode_step(self.cfg, params, tokens, cache, sharder)
        return transformer.decode_step(self.cfg, params, tokens, cache, sharder)

    def input_specs(self, shape, *, abstract=True, generator: torch.Generator | None = None):
        """The model's inputs for a ``ShapeConfig``, the reference's shapes
        and dtypes: ``meta`` tensors where ``abstract``, else values drawn
        from ``generator`` on its device, in key order (tokens and labels
        uniform over the vocabulary, embeddings standard normal). The vlm
        family's text is the stream less the prefix (at least 1 token); its
        prefix, and the audio family's frames, are left out of decode
        shapes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        cd = cfg.cdtype()
        out = {}
        if cfg.family == "vlm":
            out["tokens"] = ((B, max(S - cfg.n_prefix_tokens, 1)), torch.int32)
            if shape.kind != "decode":
                out["prefix"] = ((B, cfg.n_prefix_tokens, cfg.d_model), cd)
        else:
            out["tokens"] = ((B, S), torch.int32)
            if self.audio and shape.kind != "decode":
                out["frames"] = ((B, cfg.n_prefix_tokens, cfg.d_model), cd)
        if shape.kind == "train":
            out["labels"] = out["tokens"]
        if not abstract and generator is None:
            raise ValueError("concrete inputs need a generator")

        def make(shp, dt):
            if abstract:
                return torch.empty(shp, dtype=dt, device="meta")
            device = generator.device
            if dt == torch.int32:
                return torch.randint(0, cfg.vocab, shp, generator=generator, device=device,
                                     dtype=torch.int32)
            return torch.randn(shp, generator=generator, device=device).to(dt)

        return {k: make(*v) for k, v in out.items()}


def build_model(cfg) -> Model:
    """The model of ``cfg`` (`transformer.check_supported` raises for a
    family the port has no model of)."""
    transformer.check_supported(cfg)
    return Model(cfg)
