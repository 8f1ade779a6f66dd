"""PyTorch/CUDA port of the PolarQuant serving stack (``repro``).

The package mirrors ``repro``'s module layout: ``repro_torch/<path>`` ports
``repro/<path>``. It imports ``torch``, ``numpy`` and the standard library
only. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the hand-written Hopper kernels in ``kernels/`` launch for
CUDA tensors and their plain PyTorch versions run for CPU tensors.
"""
