"""Training and serving steps of the LM zoo (port of ``repro/train``):
the train step, the fault-tolerant loop, and the serving steps."""
from .loop import LoopConfig, train_loop
from .serve_step import decode_loop, make_prefill_step, make_serve_step
from .train_step import TrainState, init_state, make_train_step

__all__ = ["LoopConfig", "TrainState", "decode_loop", "init_state",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "train_loop"]
