"""PyTorch/CUDA port of the molecular similarity search system.

Mirrors ``repro`` module for module; imports ``torch`` and ``numpy`` only.
Engines run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
