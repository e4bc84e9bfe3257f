"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module layout so each counterpart is easy
to find (``repro_torch.core.sparse`` ports ``repro.core.sparse`` and so
on).  It imports ``torch`` and numpy only: never ``jax``, never ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise (``device.resolve``).
"""
