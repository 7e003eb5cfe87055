"""PyTorch / CUDA port of rten_tpu's serving path.

The JAX package ``rten_tpu`` stays the reference; this package mirrors its
layout (``kernels``, ``models``, ``generate``) and imports neither ``jax``
nor anything of ``rten_tpu``. Every TPU kernel on the ported path is a
hand-written Hopper kernel under ``csrc/`` with a plain PyTorch version of
the same contract beside its wrapper (see :mod:`rten_tpu_torch.kernels`).

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
