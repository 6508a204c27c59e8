"""Host-side runtime: agents, communication, discovery, orchestration.

The port's copy of ``pydcop_tpu/infrastructure/``: the control plane of
``solve --mode thread|process`` and the ``orchestrator`` and ``agent``
verbs.  The orchestrator owns the card: its ``device-solve`` thread runs
the whole DCOP as one ``api.solve_result`` on the device it was given,
then posts the per-cycle costs and one value read-back a computation to
the hosting agents, which only keep the books.  Also here: the live
metrics surface (``MetricsHttpServer``) and the websocket UI
(``UiServer``) in ``ui``, and the retry policies of the HA fleet
(``retry.RetryPolicy``).

Names resolve lazily (PEP 562): importing the package (the host-only
verbs do, for ``ui``) imports neither torch nor numpy.  The orchestrator
imports torch only when it solves; an agent never does.
"""

_LAZY = {
    "Agent": "agents",
    "AgentException": "agents",
    "AgentMetrics": "agents",
    "CommunicationLayer": "communication",
    "HttpCommunicationLayer": "communication",
    "InProcessCommunicationLayer": "communication",
    "Messaging": "communication",
    "MSG_ALGO": "communication",
    "MSG_DISCOVERY": "communication",
    "MSG_MGT": "communication",
    "MSG_VALUE": "communication",
    "ComputationException": "computations",
    "DcopComputation": "computations",
    "Message": "computations",
    "MessagePassingComputation": "computations",
    "SynchronousComputationMixin": "computations",
    "VariableComputation": "computations",
    "build_computation": "computations",
    "message_type": "computations",
    "register": "computations",
    "Directory": "discovery",
    "DirectoryComputation": "discovery",
    "Discovery": "discovery",
    "EventDispatcher": "events",
    "event_bus": "events",
    "OrchestratedAgent": "orchestratedagents",
    "OrchestrationComputation": "orchestratedagents",
    "AgentsMgt": "orchestrator",
    "Orchestrator": "orchestrator",
    "run_local_process_dcop": "run",
    "run_local_thread_dcop": "run",
    "solve": "run",
    "MetricsHttpServer": "ui",
    "UiServer": "ui",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    import importlib

    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
