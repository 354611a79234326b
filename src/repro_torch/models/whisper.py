"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the twin of the
JAX package's ``models/whisper.py``.

The conv frontend is a stub, as in the reference: the caller gives frame
embeddings (B, T, D), where the two conv1d + GELU layers would give them.
Encoder: non-causal self-attention over the frames, sinusoidal positions.
Decoder: causal self-attention, then cross-attention to the encoder's
output, with a self cache of ``max_seq`` positions and a cross cache of the
T encoder rows. A Python loop over the layers (`tree_unstack`'s views)
takes the place of ``lax.scan``. The decoder's tokens get sinusoidal
positions whatever ``cfg.pos`` says, and no attention here rotates.

The cache is written in place (JAX returns a new one): ``prefill`` writes
every leaf, zeros past the prompt in the self cache as the reference's
padded replacement, and ``decode_step`` writes one self row per layer at
each row's ``pos``, dropped at or past the cache's end as the reference's
scatter drops it; both return the cache they were given. As in the
reference, ``prefill`` caches the self and cross K and V without the
biases ``bk`` and ``bv``, where ``mha`` and the decode step's own K and V
add them (equal under `init_params`' zero biases). The decode step's two
attentions are K5 (`common.decode_attend`), cross-attention over every one
of the T rows; it reads nothing from the device. Each entry point takes the
reference's ``sharder`` and constrains the streams and logits where the
reference does (see ``transformer.py``).
"""

from __future__ import annotations

import torch

from ..distributed.local import local_write, vocab_embed
from ..distributed.sharding import scope
from .common import (
    ParamSpec,
    apply_norm,
    attention_specs,
    attn_out,
    constrain,
    decode_attend,
    heads_in,
    mha,
    mlp,
    mlp_specs,
    norm_specs,
    qkv,
    sinusoidal_pos,
    stack_tree,
    tree_unstack,
    write_row,
)


def _enc_layer_specs(cfg):
    return {"ln1": norm_specs(cfg), "attn": attention_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def whisper_specs(cfg):
    dec = {
        "ln1": norm_specs(cfg), "attn": attention_specs(cfg),
        "ln_cross": norm_specs(cfg), "cross": attention_specs(cfg),
        "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg),
    }
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "enc_in": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed2")),
        "encoder": stack_tree(_enc_layer_specs(cfg), cfg.encoder_layers),
        "enc_norm": norm_specs(cfg),
        "decoder": stack_tree(dec, cfg.n_layers),
        "final_norm": norm_specs(cfg),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(cfg, params, frames, sharder=None):
    """frames: (B, T, D) stub frontend embeddings -> (B, T, D)."""
    cd = cfg.cdtype()
    with scope(sharder):
        h = frames.to(cd) @ params["enc_in"].to(cd)
        B, T, _ = h.shape
        positions = _positions(B, T, h.device)
        h = h + sinusoidal_pos(positions, cfg.d_model).to(cd)
        h = constrain(sharder, h, "batch", "seq", "act_embed")
        for p in tree_unstack(params["encoder"], cfg.encoder_layers):
            y = apply_norm(cfg, p["ln1"], h)
            h = h + mha(cfg, p["attn"], y, positions, sharder=sharder, mode="full")
            y = apply_norm(cfg, p["ln2"], h)
            h = h + mlp(cfg, p["mlp"], y, sharder=sharder)
        return apply_norm(cfg, params["enc_norm"], h)


def _embed(cfg, params, tokens, positions, sharder=None):
    """The tokens' embeddings in the compute dtype plus their sinusoidal
    positions (B, S) -> (B, S, D)."""
    cd = cfg.cdtype()
    h = vocab_embed(sharder, tokens, params["embed"]).to(cd)
    return h + sinusoidal_pos(positions, cfg.d_model).to(cd)


def _dec_layer(cfg, p, h, positions, enc_out, enc_positions, sharder=None):
    y = apply_norm(cfg, p["ln1"], h)
    h = h + mha(cfg, p["attn"], y, positions, sharder=sharder, mode="causal")
    y = apply_norm(cfg, p["ln_cross"], h)
    h = h + mha(cfg, p["cross"], y, positions, sharder=sharder, mode="full", kv=enc_out,
                kv_positions=enc_positions)
    y = apply_norm(cfg, p["ln2"], h)
    return h + mlp(cfg, p["mlp"], y, sharder=sharder)


def _logits(cfg, params, h):
    h = apply_norm(cfg, params["final_norm"], h)
    return h @ params["lm_head"].to(h.dtype)


def forward(cfg, params, frames, tokens, sharder=None):
    """Teacher-forced pass -> (logits (B, S, V), aux = float32 0)."""
    with scope(sharder):
        enc_out = encode(cfg, params, frames, sharder)
        B, T, _ = enc_out.shape
        enc_pos = _positions(B, T, enc_out.device)
        positions = _positions(B, tokens.shape[1], enc_out.device)
        h = _embed(cfg, params, tokens, positions, sharder)
        h = constrain(sharder, h, "batch", "seq", "act_embed")
        for p in tree_unstack(params["decoder"], cfg.n_layers):
            h = _dec_layer(cfg, p, h, positions, enc_out, enc_pos, sharder)
        logits = constrain(sharder, _logits(cfg, params, h), "batch", "seq", "vocab")
        return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def cache_specs(cfg, batch: int, max_seq: int):
    L = cfg.n_layers
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    self_shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cross_shape = (L, batch, cfg.n_prefix_tokens, cfg.n_kv_heads, cfg.hd)
    return {
        "self_k": ParamSpec(self_shape, kv, "zeros"),
        "self_v": ParamSpec(self_shape, kv, "zeros"),
        "cross_k": ParamSpec(cross_shape, kv, "zeros"),
        "cross_v": ParamSpec(cross_shape, kv, "zeros"),
        "pos": ParamSpec((batch,), ("batch",), "zeros"),
    }


def init_cache(cfg, batch, max_seq, dtype, device):
    """`cache_specs`' shapes on ``device``: zeros of ``dtype``, ``pos`` int32."""
    return {key: torch.zeros(spec.shape, dtype=torch.int32 if key == "pos" else dtype,
                             device=device)
            for key, spec in cache_specs(cfg, batch, max_seq).items()}


def _fill_self(sk, sv, k, v):
    S = k.shape[1]
    sk[:, :S] = k
    sk[:, S:] = 0
    sv[:, :S] = v
    sv[:, S:] = 0


def _fill_cross(ck, cv, k, v):
    ck.copy_(k)
    cv.copy_(v)


def prefill(cfg, params, frames, tokens, cache, sharder=None):
    """Encode the frames, fill the cross cache with every layer's K and V of
    the encoder's output, run the decoder's prompt into the self cache
    (zeros past it), set every row's ``pos`` to S; return last-position
    logits (B, V) and the cache."""
    cd = cfg.cdtype()
    with scope(sharder):
        enc_out = encode(cfg, params, frames, sharder)
        B, T, _ = enc_out.shape
        if T != cache["cross_k"].shape[2]:
            raise ValueError(f"{T} frames, the cross cache holds {cache['cross_k'].shape[2]}")
        enc_pos = _positions(B, T, enc_out.device)
        S = tokens.shape[1]
        positions = _positions(B, S, enc_out.device)
        h = _embed(cfg, params, tokens, positions, sharder)
        for l, p in enumerate(tree_unstack(params["decoder"], cfg.n_layers)):
            y = apply_norm(cfg, p["ln1"], h)
            local_write(sharder, _fill_self, [cache["self_k"][l], cache["self_v"][l]],
                        [heads_in(y, p["attn"][w].to(cd), sharder, "kv_heads")
                         for w in ("wk", "wv")])
            local_write(sharder, _fill_cross, [cache["cross_k"][l], cache["cross_v"][l]],
                        [heads_in(enc_out, p["cross"][w].to(cd), sharder, "kv_heads")
                         for w in ("wk", "wv")])
            h = _dec_layer(cfg, p, h, positions, enc_out, enc_pos, sharder)
        cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
        return _logits(cfg, params, h[:, -1:])[:, 0], cache


def decode_step(cfg, params, tokens, cache, sharder=None):
    """tokens (B, 1) -> (logits (B, V), cache): each layer writes its self K
    and V at each row's ``pos`` (nothing at or past the cache's end) and
    attends over ``pos + 1`` rows, then over all T cross rows, both by K5 on
    CUDA; ``pos`` advances. Reads nothing from the device."""
    cd = cfg.cdtype()
    with scope(sharder):
        pos = cache["pos"]
        kv_len = pos + 1
        B = tokens.shape[0]
        h = _embed(cfg, params, tokens, pos[:, None], sharder)
        rows = torch.arange(B, device=h.device)
        S, T = cache["self_k"].shape[2], cache["cross_k"].shape[2]
        at, inside = pos.clamp(max=S - 1), (pos < S)[:, None, None]
        cross_len = torch.full((B,), T, dtype=torch.int32, device=h.device)
        for l, p in enumerate(tree_unstack(params["decoder"], cfg.n_layers)):
            sk, sv = cache["self_k"][l], cache["self_v"][l]
            y = apply_norm(cfg, p["ln1"], h)
            q, k, v = qkv(cfg, p["attn"], y, None, sharder=sharder)
            local_write(sharder, write_row, [sk], [at, inside, k], rows=rows)
            local_write(sharder, write_row, [sv], [at, inside, v], rows=rows)
            h = h + attn_out(cfg, p["attn"], decode_attend(q, sk, sv, kv_len, sharder=sharder),
                             sharder)
            y = apply_norm(cfg, p["ln_cross"], h)
            qc = heads_in(y, p["cross"]["wq"].to(cd), sharder)
            if cfg.use_bias:
                qc = qc + p["cross"]["bq"].to(cd)
            out = decode_attend(qc, cache["cross_k"][l], cache["cross_v"][l], cross_len,
                                sharder=sharder)
            h = h + attn_out(cfg, p["cross"], out, sharder)
            y = apply_norm(cfg, p["ln2"], h)
            h = h + mlp(cfg, p["mlp"], y, sharder=sharder)
        cache["pos"] = kv_len
        return _logits(cfg, params, h)[:, 0], cache
