"""The replication negotiation of the thread runtime at N agents, in the
port or in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tests/negotiation_scale.py torch|jax N

The problem is ``chip_smoke.py``'s ``run_scenario`` at N variables: a
soft scale-free coloring of seed 7 with one agent per variable, each of
capacity 1,000, hosting costs 0 (``name_mapping``), routes drawn in [0,
100) to two decimals, through the port's ``dcop_yaml``; the chosen
package loads it, starts a thread-mode run (MaxSum, ``adhoc``), deploys
it and runs one ``start_replication(2)`` round in ``distributed`` mode
(600 s at most).  Prints one JSON object: each stage's seconds, the
visits that timed out (each a refusal after the visits' 2 s), whether
the placement is the oracle's (``rank_hosts`` on ``owner_paths``, which
``tests/test_torch_replication.py`` holds to JAX's search), each
visit's seconds to its answer (largest, 99th percentile, median), and
how far apart the agents started their rounds.  Each stage's seconds
also go to stderr as it ends.

Not a test: its times are the host's.
"""

import json
import logging
import os
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pydcop_tpu_torch.commands.generators.agents import (  # noqa: E402
    generate_agent_defs,
    generate_agents_from_variables,
)
from pydcop_tpu_torch.commands.generators.graphcoloring import (  # noqa: E402
    generate_graph_coloring,
)
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml  # noqa: E402
from pydcop_tpu_torch.replication import rank_hosts  # noqa: E402
from pydcop_tpu_torch.replication.path_utils import owner_paths  # noqa: E402


def _stage(name, t0, out):
    out[name] = time.perf_counter() - t0
    print(f"{name} {out[name]:.2f} s", file=sys.stderr, flush=True)


def main(impl: str, n: int) -> dict:
    out = {"impl": impl, "n": n}
    t0 = time.perf_counter()
    dcop = generate_graph_coloring(n, 3, graph="scalefree", m_edge=2,
                                   soft=True, seed=7)
    comps = sorted(dcop.variables)
    dcop._agents_def.clear()
    dcop.add_agents(generate_agent_defs(
        generate_agents_from_variables(comps), capacity=1000,
        hosting_mode="name_mapping", computations=comps,
        default_hosting_cost=0, default_route=1, routes_range=100, seed=7))
    text = dcop_yaml(dcop)
    _stage("yaml_dump_s", t0, out)
    if impl == "jax":
        from pydcop_tpu.algorithms import AlgorithmDef
        from pydcop_tpu.dcop.yamldcop import load_dcop
        from pydcop_tpu.infrastructure.run import _build, run_local_thread_dcop
        from pydcop_tpu.resilience.negotiation import ReplicationComputation
        kwargs = {}
    else:
        from pydcop_tpu_torch.algorithms import AlgorithmDef
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop
        from pydcop_tpu_torch.infrastructure.run import (
            _build,
            run_local_thread_dcop,
        )
        from pydcop_tpu_torch.resilience.negotiation import (
            ReplicationComputation,
        )
        kwargs = {"device": "cpu"}
    rc = ReplicationComputation
    answers, starts, timed_out = [], [], []
    lock = threading.Lock()

    def timed(handler):
        def wrapped(self, sender, msg, t):
            neg = self._neg
            if (neg is not None and neg["outstanding"] is not None
                    and neg["comp"] == msg.comp
                    and neg["outstanding"][0] == msg.host):
                with lock:
                    answers.append(time.monotonic() - neg["outstanding"][1])
            return handler(self, sender, msg, t)
        return wrapped

    for name in ("ucs_accept", "ucs_refuse"):
        rc._msg_handlers[name] = timed(rc._msg_handlers[name])
    start_round = rc.start_round

    def timed_start(self, *args, **kw):
        with lock:
            starts.append(time.monotonic())
        return start_round(self, *args, **kw)

    rc.start_round = timed_start

    class Timeouts(logging.Handler):
        def emit(self, record):
            if "timed out after" in record.getMessage():
                timed_out.append(record.getMessage())

    logging.getLogger().addHandler(Timeouts())
    logging.getLogger().setLevel(logging.WARNING)

    t0 = time.perf_counter()
    dcop = load_dcop(text)
    _stage("yaml_load_s", t0, out)
    algo = AlgorithmDef.build_with_default_param(
        "maxsum", {"damping": 0.7, "layout": "ell"}, mode=dcop.objective)
    t0 = time.perf_counter()
    orchestrator = run_local_thread_dcop(
        algo, dcop, "adhoc", n_cycles=10, seed=7,
        replication_mode="distributed", **kwargs)
    _stage("start_s", t0, out)
    try:
        t0 = time.perf_counter()
        orchestrator.deploy_computations(timeout=300)
        orchestrator.mgt.ready_to_run.wait(300)
        _stage("deploy_s", t0, out)
        t0 = time.perf_counter()
        try:
            orchestrator.start_replication(2, timeout=600)
            _stage("replication_s", t0, out)
        except TimeoutError as exc:
            out["replication_s"] = None
            out["replication_error"] = str(exc)[:300]
        placement = {c: list(h)
                     for c, h in orchestrator.mgt.replica_hosts.items()}
    finally:
        orchestrator.stop_agents(timeout=60)
        orchestrator.stop()

    _, _, distribution = _build(dcop, algo, "adhoc")
    names = list(dcop.agents)
    paths, oracle = {}, {}
    for comp in distribution.computations:
        owner = distribution.agent_for(comp)
        if owner not in paths:
            owner_def = dcop.agents[owner]
            paths[owner] = owner_paths(
                owner, lambda a, b, _o=owner, _d=owner_def:
                float(_d.route(b)) if a == _o else 1.0, names)
        oracle[comp] = rank_hosts(
            owner, comp, 2, names, paths[owner],
            lambda a, c: float(dcop.agents[a].hosting_cost(c)))
    answers.sort()
    out.update(
        timed_out=len(timed_out), placement_is_oracle=placement == oracle,
        replicas=sum(len(h) for h in placement.values()),
        answered=len(answers),
        answer_max_s=answers[-1] if answers else None,
        answer_p99_s=answers[int(0.99 * (len(answers) - 1))]
        if answers else None,
        answer_p50_s=answers[len(answers) // 2] if answers else None,
        round_starts_spread_s=max(starts) - min(starts) if starts else None,
        cpus=os.cpu_count(),
    )
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], int(sys.argv[2]))))
