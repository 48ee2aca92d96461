"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (prefill), ``decode_attention``, the paged
pair ``paged_decode_attention`` and ``paged_prefill_attention``,
``selective_scan`` (Mamba prefill) and ``rmsnorm``.

Importing this package or its modules needs neither ``nvcc`` nor
``triton``: the kernels are built by :mod:`._build` at their first call
with a CUDA tensor. A CPU tensor goes through the plain version.
"""
