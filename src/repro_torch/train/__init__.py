"""Serving steps of the LM zoo (port of ``repro/train``'s serving half).
Training (``train_step``, ``loop``) comes with a later slice."""
from .serve_step import decode_loop, make_prefill_step, make_serve_step

__all__ = ["decode_loop", "make_prefill_step", "make_serve_step"]
