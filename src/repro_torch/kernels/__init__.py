"""Hopper kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version for CPU tensors and launches its CUDA
kernel for CUDA tensors (``csrc/*.cu``, built by ``_build`` at first use);
``<wrapper>.launches`` counts kernel launches. The model code reaches them
through ``ops``, which dispatches to the kernel backend in scope
(``repro_torch.api.backends``: ``cuda`` calls these wrappers, ``ref`` the
plain versions of ``ref.py``). ``autotune`` picks the flash prefills' tile
for each ``cuda`` call (the twin of ``repro.kernels.autotune``).
"""
