"""pydcop_tpu_torch: the PyTorch/CUDA port of pydcop_tpu.

A second package beside ``pydcop_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout so each module's
counterpart is found under the same path, and it runs the same math on
the same compiled arrays: plain functions on tensors, dataclasses of
tensors in place of pytrees, an explicit ``device`` argument, and an
explicit PRNG key.  Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``compile/hopper_kernels.py``, sources
under ``csrc/``).

Ported so far, single device: the object-level front door (the DCOP
model, the YAML loader, ``compile_dcop``, ``api.solve_result`` and
``python -m pydcop_tpu_torch solve``), MaxSum on every layout
(``algorithms.maxsum``), the local-search solvers DSA, MGM and MGM-2
(``algorithms.dsa``, ``.mgm``, ``.mgm2``) on one cycle engine
(``algorithms.base.run_cycles``) that runs each solve on the card as
replays of captured CUDA graphs, and DPOP (``algorithms.dpop``), whose
UTIL wave is one captured graph where it fits; serving, telemetry and
durability; and the agent runtime (``infrastructure``: the orchestrator
that solves on the card, agents in threads or processes).  Entry points run on
``device="cuda"`` unless the caller asks for the CPU, and raise when no
card is present.
"""

__version__ = "0.1.0"

# Public names are resolved lazily (PEP 562), so importing the package
# (the CLI does, for --help too) does not import torch.
_LAZY = {
    "solve": ("pydcop_tpu_torch.api", "solve"),
    "solve_result": ("pydcop_tpu_torch.api", "solve_result"),
    "DCOP": ("pydcop_tpu_torch.dcop", "DCOP"),
    "AgentDef": ("pydcop_tpu_torch.dcop", "AgentDef"),
    "Domain": ("pydcop_tpu_torch.dcop", "Domain"),
    "Variable": ("pydcop_tpu_torch.dcop", "Variable"),
    "constraint_from_str": ("pydcop_tpu_torch.dcop", "constraint_from_str"),
    "load_dcop": ("pydcop_tpu_torch.dcop", "load_dcop"),
    "load_dcop_from_file": ("pydcop_tpu_torch.dcop", "load_dcop_from_file"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
