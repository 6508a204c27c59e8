"""pydcop_tpu_torch: the PyTorch/CUDA port of pydcop_tpu.

A second package beside ``pydcop_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout so each module's
counterpart is found under the same path, and it runs the same math on
the same compiled arrays: plain functions on tensors, dataclasses of
tensors in place of pytrees, an explicit ``device`` argument, and an
explicit PRNG key.  Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``compile/hopper_kernels.py``, sources
under ``csrc/``).

Ported so far, single device: MaxSum on every layout
(``algorithms.maxsum``) and the local-search solvers DSA, MGM and MGM-2
(``algorithms.dsa``, ``.mgm``, ``.mgm2``), on one cycle engine
(``algorithms.base.run_cycles``) that runs each solve on the card as
replays of captured CUDA graphs, fed by the array-level graph-coloring
and Ising generators.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU, and raise when no card is present.
"""

__version__ = "0.1.0"
