"""Serving: prefill/decode step factories, the paged-serving loop, scheduler,
SepBIT KV page store."""
from .engine import make_decode_fn, make_prefill_fn, request_traffic, serve_paged

__all__ = ["make_prefill_fn", "make_decode_fn", "request_traffic", "serve_paged"]
