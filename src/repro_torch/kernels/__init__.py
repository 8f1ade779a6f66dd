"""Hand-written Hopper (sm_90a) CUDA kernels for the PolarQuant hot spots,
each beside its plain PyTorch version: ``polar_encode``, ``paged_decode``,
``flash_prefill``, ``paged_prefill``, ``polar_attention`` and ``polar_qk``
(one module each, sources in ``csrc/``), with the public entries in
``ops``. ``_build.py`` compiles the sources with ``nvcc`` at first use;
nothing builds at import time.

The package does not re-export the entries, so ``from
repro_torch.kernels import polar_encode`` names the kernel module (and
its ``launches`` counter), not the function.
"""
