"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their dispatch.  Importing this package builds nothing: the kernels are
compiled on first launch (``_build.library``)."""
from .policy import KernelPolicy

__all__ = ["KernelPolicy"]
