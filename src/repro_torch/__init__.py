"""PyTorch/CUDA port of the frequent-episode miner (``repro``) for an
NVIDIA H100.

Laid out module for module like ``repro``; imports neither ``jax`` nor
``repro``. The two TPU kernels of the episode-parallel path are
hand-written CUDA kernels for ``sm_90a`` (``kernels/csrc``), each beside
its plain PyTorch version. Entry points take ``device`` and default to the
CUDA card (``repro_torch.device.resolve_device``).
"""
