"""onedc_tpu_torch: the PyTorch / CUDA (Hopper) port of ``onedc_tpu``.

Decode side of the lambda family: bitstream -> codec four-part prior ->
one-step SD UNet -> VAE decoder. Layout mirrors ``onedc_tpu``; each module
names its JAX counterpart. The port imports ``torch``, numpy and scipy,
never ``jax`` and nothing of ``onedc_tpu``. Hand-written CUDA kernels live
in ``csrc/`` and are built at first use into ``build/onedc_tpu_torch/``.
"""
