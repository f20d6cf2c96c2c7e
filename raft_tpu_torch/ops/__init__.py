"""Tensor ops of the port: plain PyTorch versions and CUDA kernel
wrappers (``corr_kernels``, ``gru_gates``, ``pyramid_kernels``,
``lookup_encode``, ``upsample_loss``; built by ``build``), and
``corr_bwd_probe``, a measurement aid run on the card."""
