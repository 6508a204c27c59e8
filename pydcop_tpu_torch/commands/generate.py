"""``generate``: benchmark problem generation.

Counterpart of ``pydcop_tpu/commands/generate.py``, with the same nine
families, flags, defaults and text: ``graph_coloring``, ``ising``,
``meeting_scheduling``, ``secp``, ``mixed_problem``, ``iot`` (with the
``dist_<name>`` distribution file beside ``--output``), ``small_world``,
``agents`` and ``scenario``, each written as YAML to stdout or
``--output`` through the port's ``dcop_yaml``, ``yaml_agents`` and
``yaml_scenario``.  For the same arguments the files are byte for byte
the JAX package's.  The verb only writes files: it runs on the host,
without a card.
"""

from __future__ import annotations

import os
import sys
from typing import Any

from ..dcop.yamldcop import (
    dcop_yaml,
    load_dcop_from_file,
    yaml_agents,
    yaml_scenario,
)


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "generate", help="generate benchmark problems"
    )
    parser.set_defaults(
        func=lambda args, timeout=None: (parser.print_help(), 2)[1]
    )
    sub = parser.add_subparsers(dest="problem")

    gc = sub.add_parser("graph_coloring", help="graph coloring problems")
    gc.set_defaults(func=_gen_graph_coloring)
    gc.add_argument("-v", "--variables_count", type=int, required=True)
    gc.add_argument("-c", "--colors_count", type=int, default=3)
    gc.add_argument(
        "-g", "--graph", choices=["random", "scalefree", "grid"],
        default="random",
    )
    gc.add_argument("--p_edge", type=float, default=None)
    gc.add_argument("--m_edge", type=int, default=None)
    gc.add_argument("--soft", action="store_true")
    gc.add_argument("--extensive", action="store_true")
    gc.add_argument("--noise_level", type=float, default=0.02)
    gc.add_argument("--allow_subgraph", action="store_true")
    gc.add_argument("--seed", type=int, default=None)
    _add_output(gc)

    is_ = sub.add_parser("ising", help="ising model problems")
    is_.set_defaults(func=_gen_ising)
    is_.add_argument("--row_count", type=int, required=True)
    is_.add_argument("--col_count", type=int, default=None)
    is_.add_argument("--bin_range", type=float, default=1.6)
    is_.add_argument("--un_range", type=float, default=0.05)
    is_.add_argument("--intentional", action="store_true")
    is_.add_argument("--no_agents", action="store_true")
    is_.add_argument("--seed", type=int, default=None)
    _add_output(is_)

    ms = sub.add_parser(
        "meeting_scheduling", help="PEAV meeting scheduling problems"
    )
    ms.set_defaults(func=_gen_meetings)
    ms.add_argument("--slots_count", type=int, default=5)
    ms.add_argument("--resources_count", type=int, default=3)
    ms.add_argument("--max_resource_value", type=int, default=10)
    ms.add_argument("--events_count", type=int, default=3)
    ms.add_argument("--max_length_event", type=int, default=2)
    ms.add_argument("--max_resources_event", type=int, default=2)
    ms.add_argument("--penalty", type=int, default=100)
    ms.add_argument("--seed", type=int, default=0)
    _add_output(ms)

    secp = sub.add_parser("secp", help="smart environment problems")
    secp.set_defaults(func=_gen_secp)
    secp.add_argument("-l", "--lights", type=int, default=3)
    secp.add_argument("-m", "--models", type=int, default=2)
    secp.add_argument("-r", "--rules", type=int, default=2)
    secp.add_argument("-c", "--capacity", type=int, default=100)
    secp.add_argument("--max_model_size", type=int, default=3)
    secp.add_argument("--max_rule_size", type=int, default=2)
    secp.add_argument("--seed", type=int, default=0)
    _add_output(secp)

    mx = sub.add_parser(
        "mixed_problem", help="mixed hard/soft constraint problems"
    )
    mx.set_defaults(func=_gen_mixed)
    mx.add_argument("-v", "--variable_count", type=int, required=True)
    mx.add_argument("-c", "--constraint_count", type=int, required=True)
    mx.add_argument(
        "-H", "--hard_constraint", type=float, required=True,
        help="proportion of hard constraints, in [0, 1]",
    )
    mx.add_argument("-A", "--arity", type=int, default=2)
    mx.add_argument(
        "-r", "--range", type=int, required=True, dest="domain_range",
        help="variables take values 0, 1, ..., r-1",
    )
    mx.add_argument("-d", "--density", type=float, required=True)
    mx.add_argument("-a", "--agents", type=int, default=None)
    mx.add_argument("--capacity", type=int, default=0)
    mx.add_argument("--seed", type=int, default=None)
    _add_output(mx)

    iot = sub.add_parser("iot", help="IoT powerlaw problems")
    iot.set_defaults(func=_gen_iot)
    iot.add_argument("-n", "--num", type=int, default=30)
    iot.add_argument("-d", "--domain", type=int, default=10)
    iot.add_argument("-r", "--range", type=int, default=100)
    iot.add_argument("--seed", type=int, default=0)
    _add_output(iot)

    sw = sub.add_parser("small_world", help="small-world problems")
    sw.set_defaults(func=_gen_smallworld)
    sw.add_argument("-n", "--num", type=int, default=20)
    sw.add_argument("-k", "--degree", type=int, default=4)
    sw.add_argument("-p", "--rewire", type=float, default=0.1)
    sw.add_argument("-d", "--domain", type=int, default=5)
    sw.add_argument("-r", "--range", type=int, default=10)
    sw.add_argument("--seed", type=int, default=None)
    _add_output(sw)

    ag = sub.add_parser("agents", help="agent definitions for a dcop")
    ag.set_defaults(func=_gen_agents)
    ag.add_argument("--dcop_files", nargs="+", default=None)
    ag.add_argument("--count", type=int, default=None)
    ag.add_argument("--agent_prefix", default="a")
    ag.add_argument("--capacity", type=int, default=None)
    ag.add_argument(
        "--hosting", choices=["None", "name_mapping"], default="None"
    )
    ag.add_argument("--hosting_default", type=float, default=0)
    ag.add_argument("--routes_default", type=float, default=1)
    ag.add_argument("--routes_range", type=float, default=None)
    ag.add_argument("--seed", type=int, default=0)
    _add_output(ag)

    sc = sub.add_parser("scenario", help="agent-removal scenarios")
    sc.set_defaults(func=_gen_scenario)
    sc.add_argument("--evts_count", type=int, required=True)
    sc.add_argument("--actions_count", type=int, default=1)
    sc.add_argument("--delay", type=float, default=10)
    sc.add_argument("--initial_delay", type=float, default=5)
    sc.add_argument("--end_delay", type=float, default=5)
    sc.add_argument("--dcop_files", nargs="+", default=None)
    sc.add_argument("--agents", nargs="+", default=None)
    sc.add_argument("--seed", type=int, default=0)
    _add_output(sc)


def _add_output(parser) -> None:
    parser.add_argument("-o", "--output", default=None)


def _emit(args, text: str) -> int:
    if getattr(args, "output", None):
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _gen_graph_coloring(args, timeout=None) -> int:
    from .generators.graphcoloring import generate_graph_coloring

    dcop = generate_graph_coloring(
        args.variables_count,
        args.colors_count,
        graph=args.graph,
        p_edge=args.p_edge,
        m_edge=args.m_edge,
        soft=args.soft,
        extensive=args.extensive,
        noise_level=args.noise_level,
        seed=args.seed,
        allow_subgraph=args.allow_subgraph,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_ising(args, timeout=None) -> int:
    from .generators.ising import generate_ising

    dcop = generate_ising(
        args.row_count,
        args.col_count or args.row_count,
        bin_range=args.bin_range,
        un_range=args.un_range,
        extensive=not args.intentional,
        no_agents=args.no_agents,
        seed=args.seed,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_meetings(args, timeout=None) -> int:
    from .generators.meetingscheduling import generate_meeting_scheduling

    dcop = generate_meeting_scheduling(
        slots_count=args.slots_count,
        resources_count=args.resources_count,
        max_resource_value=args.max_resource_value,
        events_count=args.events_count,
        max_length_event=args.max_length_event,
        max_resources_event=args.max_resources_event,
        penalty=args.penalty,
        seed=args.seed,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_secp(args, timeout=None) -> int:
    from .generators.secp import generate_secp

    dcop = generate_secp(
        lights=args.lights,
        models=args.models,
        rules=args.rules,
        capacity=args.capacity,
        max_model_size=args.max_model_size,
        max_rule_size=args.max_rule_size,
        seed=args.seed,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_mixed(args, timeout=None) -> int:
    from .generators.mixedproblem import generate_mixed_problem

    dcop = generate_mixed_problem(
        args.variable_count,
        args.constraint_count,
        args.hard_constraint,
        arity=args.arity,
        domain_range=args.domain_range,
        density=args.density,
        agents=args.agents,
        capacity=args.capacity,
        seed=args.seed,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_iot(args, timeout=None) -> int:
    import yaml as _yaml

    from .generators.iot import generate_iot

    dcop, mapping = generate_iot(
        num=args.num,
        domain_size=args.domain,
        constraint_range=args.range,
        seed=args.seed,
    )
    out = dcop_yaml(dcop)
    if args.output:
        _emit(args, out)
        dirname, basename = os.path.split(args.output)
        dist_path = os.path.join(dirname, f"dist_{basename}")
        with open(dist_path, "w", encoding="utf-8") as f:
            f.write(_yaml.dump({"distribution": mapping}))
        return 0
    return _emit(args, out)


def _gen_smallworld(args, timeout=None) -> int:
    from .generators.smallworld import generate_small_world

    dcop = generate_small_world(
        n=args.num,
        k=args.degree,
        p=args.rewire,
        domain_size=args.domain,
        cost_range=args.range,
        seed=args.seed,
    )
    return _emit(args, dcop_yaml(dcop))


def _gen_agents(args, timeout=None) -> int:
    from .generators.agents import (
        generate_agent_defs,
        generate_agents_from_count,
        generate_agents_from_variables,
    )

    computations: Any = []
    if args.dcop_files:
        dcop = load_dcop_from_file(args.dcop_files)
        computations = sorted(dcop.variables)
        names = generate_agents_from_variables(
            computations, args.agent_prefix
        )
    elif args.count:
        names = generate_agents_from_count(args.count, args.agent_prefix)
    else:
        raise ValueError("one of --dcop_files / --count is required")
    agents = generate_agent_defs(
        names,
        capacity=args.capacity,
        hosting_mode=None if args.hosting == "None" else args.hosting,
        computations=computations,
        default_hosting_cost=args.hosting_default,
        default_route=args.routes_default,
        routes_range=args.routes_range,
        seed=args.seed,
    )
    return _emit(args, yaml_agents(agents))


def _gen_scenario(args, timeout=None) -> int:
    from .generators.scenario import generate_scenario

    if args.agents:
        agents = args.agents
    elif args.dcop_files:
        dcop = load_dcop_from_file(args.dcop_files)
        agents = sorted(dcop.agents)
    else:
        raise ValueError("one of --agents / --dcop_files is required")
    scenario = generate_scenario(
        args.evts_count,
        args.actions_count,
        args.delay,
        args.initial_delay,
        args.end_delay,
        agents,
        seed=args.seed,
    )
    return _emit(args, yaml_scenario(scenario))
