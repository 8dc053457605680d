"""RichSem on PyTorch and CUDA: the port of ``richsem_tpu`` to one NVIDIA H100.

The JAX package ``richsem_tpu`` stays the reference. This package keeps its
layout and module names, so each module's counterpart is easy to find, and
imports neither JAX nor ``richsem_tpu``. Every Pallas kernel of the JAX
package and of its ``tools/`` probes is a hand-written CUDA kernel for
``sm_90a`` (``csrc/``), built at first use by :mod:`richsem_tpu_torch.ops._build`;
on CPU tensors their wrappers run the plain PyTorch versions beside them. The
trainer's entry point is ``python -m richsem_tpu_torch.train.main``.
"""

__version__ = "0.1.0"
