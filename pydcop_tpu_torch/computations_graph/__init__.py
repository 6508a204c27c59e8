"""Computation graphs: the port's copy of the part of
``pydcop_tpu/computations_graph/`` that its generators need (the base
objects and the factor graph)."""
