"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built for sm_90a at
first use by ``_build``), each with a ``kernel.py`` launch wrapper, a
``ref.py`` plain PyTorch version and an ``ops.py`` that dispatches on the
tensor's device: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise."""
