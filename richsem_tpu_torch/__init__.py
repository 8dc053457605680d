"""RichSem on PyTorch and CUDA: the port of ``richsem_tpu`` to one NVIDIA H100.

The JAX package ``richsem_tpu`` stays the reference. This package keeps its
layout and module names, so each module's counterpart is easy to find, and
imports neither JAX nor ``richsem_tpu``. The two Pallas kernels on the eval
path are hand-written CUDA kernels for ``sm_90a`` (``csrc/``), built at first
use by :mod:`richsem_tpu_torch.ops._build`; on CPU tensors their wrappers run
the plain PyTorch versions beside them.
"""

__version__ = "0.1.0"
