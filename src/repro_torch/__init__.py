"""Hydra in PyTorch: the port of ``repro`` to PyTorch and CUDA on Hopper.

The package mirrors ``repro``'s module layout, so each module's
counterpart sits at the same path. It imports ``torch`` and never
``jax``, and nothing of ``repro``: what it needs from there is copied.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise (``repro_torch.device``).
"""
