"""PyTorch/CUDA port of ``repro`` (the distributed dataframe + priced
serverless communicator), written for one NVIDIA H100.

The package mirrors ``repro``'s subpackage and module names, so each ported
module has an obvious counterpart there; it imports ``torch`` and numpy and
nothing of ``repro`` or ``jax``.  Entry points build on the card unless the
caller asks for the CPU (``device="cpu"``); operators follow the device of
their input tensors.  Every TPU kernel on a ported path is a hand-written
CUDA kernel under ``kernels/csrc``; its wrapper launches it for a CUDA tensor
and its plain PyTorch version (``ref.py``) serves a CPU tensor.
"""

from repro_torch.device import resolve_device  # noqa: F401
