"""pydcop_tpu_torch: the PyTorch/CUDA port of pydcop_tpu.

A second package beside ``pydcop_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout so each module's
counterpart is found under the same path, and it runs the same math on
the same compiled arrays: plain functions on tensors, dataclasses of
tensors in place of pytrees, an explicit ``device`` argument, and an
explicit PRNG key.  Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``compile/hopper_kernels.py``, sources
under ``csrc/``).

Ported so far: MaxSum on the ELL layout, single device
(``algorithms.maxsum.solve``), fed by the array-level graph-coloring
generator.  Entry points run on ``device="cuda"`` unless the caller asks
for the CPU, and raise when no card is present.
"""

__version__ = "0.1.0"
