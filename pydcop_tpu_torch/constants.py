"""Package-wide constants.

Counterpart of ``pydcop_tpu/constants.py``: kept in a module with no heavy
imports, so the CLI's parsers can name the default without importing
torch.
"""

# value standing in for symbolic infinity when reporting hard-constraint
# costs; same default as the reference (pydcop/commands/solve.py:316)
INFINITY = 10000
