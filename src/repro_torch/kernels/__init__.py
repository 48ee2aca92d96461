"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``flash_attention`` (prefill; under grad its backward,
``flash_attention_bwd``, is a kernel too), ``decode_attention``, the
paged pair ``paged_decode_attention`` and ``paged_prefill_attention``,
``selective_scan`` (Mamba prefill; under grad its backward,
``selective_scan_bwd``, is a kernel too) and ``rmsnorm``. The kernels
without a backward refuse to run under grad (``_build.refuse_grad``).

Importing this package or its modules needs neither ``nvcc`` nor
``triton``: the kernels are built by :mod:`._build` at their first call
with a CUDA tensor. A CPU tensor goes through the plain version.
"""
