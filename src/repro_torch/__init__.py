"""PyTorch/CUDA port of the ``repro`` serving path.

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, but imports nothing of it (nor
JAX).  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
