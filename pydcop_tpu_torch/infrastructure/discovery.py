"""Discovery: the name service mapping computations to agents and agents to
addresses, with membership subscriptions.

The port's copy of ``pydcop_tpu/infrastructure/discovery.py``: the
``Directory`` (server state and subscription tables) hosted as a
``DirectoryComputation`` on the orchestrator's agent, and a per-agent
``Discovery`` cache and API backed by a ``DiscoveryComputation`` client.
Registrations may be published to the directory or kept local;
subscriptions deliver add/remove callbacks for agents, computations and
replicas.  Discovery traffic has the highest priority (``MSG_DISCOVERY``).
It routes control-plane names only.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .communication import MSG_DISCOVERY
from .computations import Message, MessagePassingComputation, message_type, register

__all__ = [
    "DiscoveryException",
    "UnknownAgent",
    "UnknownComputation",
    "Directory",
    "DirectoryComputation",
    "Discovery",
    "DiscoveryComputation",
    "DIRECTORY_COMP_NAME",
]

logger = logging.getLogger("pydcop_tpu_torch.infrastructure.discovery")

DIRECTORY_COMP_NAME = "_directory"


class DiscoveryException(Exception):
    pass


class UnknownAgent(DiscoveryException):
    pass


class UnknownComputation(DiscoveryException):
    pass


PublishAgentMessage = message_type(
    "publish_agent", ["agent", "address"]
)
UnpublishAgentMessage = message_type("unpublish_agent", ["agent"])
PublishComputationMessage = message_type(
    "publish_computation", ["computation", "agent", "address"]
)
UnpublishComputationMessage = message_type(
    "unpublish_computation", ["computation"]
)
PublishReplicaMessage = message_type(
    "publish_replica", ["replica", "agent"]
)
UnpublishReplicaMessage = message_type(
    "unpublish_replica", ["replica", "agent"]
)
SubscribeMessage = message_type(
    # kind: 'agent' | 'computation' | 'replica'; name may be None for all
    "subscribe", ["kind", "name", "subscribe"]
)


class Directory:
    """Server-side state: registrations + subscription tables (pyDCOP
    discovery.py:294)."""

    def __init__(self) -> None:
        self.agents: Dict[str, Any] = {}
        self.computations: Dict[str, str] = {}  # comp -> agent
        self.replicas: Dict[str, Set[str]] = {}  # comp -> {agents}
        # kind -> name (or '*') -> {subscriber agent names}
        self.subscriptions: Dict[str, Dict[str, Set[str]]] = {
            "agent": {},
            "computation": {},
            "replica": {},
        }

    def subscribers(self, kind: str, name: str) -> Set[str]:
        table = self.subscriptions[kind]
        return set(table.get(name, set())) | set(table.get("*", set()))

    def subscribe(self, kind: str, name: Optional[str], agent: str) -> None:
        self.subscriptions[kind].setdefault(name or "*", set()).add(agent)

    def unsubscribe(self, kind: str, name: Optional[str], agent: str) -> None:
        self.subscriptions[kind].get(name or "*", set()).discard(agent)


class DirectoryComputation(MessagePassingComputation):
    """The directory service as a message-passing computation hosted on the
    orchestrator's agent (pyDCOP discovery.py:121)."""

    def __init__(self, directory: Optional[Directory] = None) -> None:
        super().__init__(DIRECTORY_COMP_NAME)
        self.directory = directory or Directory()

    def _notify(self, kind: str, name: str, msg: Message) -> None:
        for sub in self.directory.subscribers(kind, name):
            self.post_msg(f"_discovery_{sub}", msg, MSG_DISCOVERY)

    @register("publish_agent")
    def _on_publish_agent(self, sender: str, msg, t: float) -> None:
        self.directory.agents[msg.agent] = msg.address
        self._notify("agent", msg.agent, msg)

    @register("unpublish_agent")
    def _on_unpublish_agent(self, sender: str, msg, t: float) -> None:
        self.directory.agents.pop(msg.agent, None)
        self._notify("agent", msg.agent, msg)

    @register("publish_computation")
    def _on_publish_computation(self, sender: str, msg, t: float) -> None:
        self.directory.computations[msg.computation] = msg.agent
        self._notify("computation", msg.computation, msg)

    @register("unpublish_computation")
    def _on_unpublish_computation(self, sender: str, msg, t: float) -> None:
        self.directory.computations.pop(msg.computation, None)
        self._notify("computation", msg.computation, msg)

    @register("publish_replica")
    def _on_publish_replica(self, sender: str, msg, t: float) -> None:
        self.directory.replicas.setdefault(msg.replica, set()).add(msg.agent)
        self._notify("replica", msg.replica, msg)

    @register("unpublish_replica")
    def _on_unpublish_replica(self, sender: str, msg, t: float) -> None:
        self.directory.replicas.get(msg.replica, set()).discard(msg.agent)
        self._notify("replica", msg.replica, msg)

    @register("subscribe")
    def _on_subscribe(self, sender: str, msg, t: float) -> None:
        # sender is the subscriber's discovery computation: _discovery_<agent>
        agent = sender[len("_discovery_"):]
        if msg.subscribe:
            self.directory.subscribe(msg.kind, msg.name, agent)
            # send current state so the subscriber starts consistent
            if msg.kind == "agent":
                for a, addr in self.directory.agents.items():
                    if msg.name in (None, a):
                        self.post_msg(
                            sender,
                            PublishAgentMessage(agent=a, address=addr),
                            MSG_DISCOVERY,
                        )
            elif msg.kind == "computation":
                for c, a in self.directory.computations.items():
                    if msg.name in (None, c):
                        addr = self.directory.agents.get(a)
                        self.post_msg(
                            sender,
                            PublishComputationMessage(
                                computation=c, agent=a, address=addr
                            ),
                            MSG_DISCOVERY,
                        )
            elif msg.kind == "replica":
                for c, agents in self.directory.replicas.items():
                    if msg.name in (None, c):
                        for a in agents:
                            self.post_msg(
                                sender,
                                PublishReplicaMessage(replica=c, agent=a),
                                MSG_DISCOVERY,
                            )
        else:
            self.directory.unsubscribe(msg.kind, msg.name, agent)


class DiscoveryComputation(MessagePassingComputation):
    """Client-side discovery endpoint: receives publish/unpublish events from
    the directory and updates the agent's Discovery cache (pyDCOP
    discovery.py:557)."""

    def __init__(self, discovery: "Discovery") -> None:
        super().__init__(f"_discovery_{discovery.agent_name}")
        self.discovery = discovery

    @register("publish_agent")
    def _on_agent(self, sender: str, msg, t: float) -> None:
        self.discovery._cache_agent(msg.agent, msg.address)

    @register("unpublish_agent")
    def _on_agent_removed(self, sender: str, msg, t: float) -> None:
        self.discovery._uncache_agent(msg.agent)

    @register("publish_computation")
    def _on_computation(self, sender: str, msg, t: float) -> None:
        self.discovery._cache_computation(
            msg.computation, msg.agent, msg.address
        )

    @register("unpublish_computation")
    def _on_computation_removed(self, sender: str, msg, t: float) -> None:
        self.discovery._uncache_computation(msg.computation)

    @register("publish_replica")
    def _on_replica(self, sender: str, msg, t: float) -> None:
        self.discovery._cache_replica(msg.replica, msg.agent, True)

    @register("unpublish_replica")
    def _on_replica_removed(self, sender: str, msg, t: float) -> None:
        self.discovery._cache_replica(msg.replica, msg.agent, False)


class Discovery:
    """Per-agent discovery API: a synchronous local cache plus asynchronous
    publish/subscribe against the directory (pyDCOP discovery.py:654).

    Callbacks registered with ``subscribe_*`` fire as
    ``cb(event, name, value)`` with event 'agent_added'/'agent_removed'/
    'computation_added'/'computation_removed'/'replica_added'/
    'replica_removed'.
    """

    def __init__(self, agent_name: str, address: Any = None) -> None:
        self.agent_name = agent_name
        self.own_address = address
        self._agents: Dict[str, Any] = {}
        self._computations: Dict[str, str] = {}
        self._replicas: Dict[str, Set[str]] = {}
        self._lock = threading.RLock()
        # subscription records (callback | None, one_shot): None marks a
        # cache-only subscription (subscribe with no callback) that still
        # counts as local interest, so another consumer's unsubscribe
        # cannot cancel the directory pushes it relies on
        self._agent_cbs: List[Tuple[Optional[Callable], bool]] = []
        self._computation_cbs: Dict[
            str, List[Tuple[Optional[Callable], bool]]
        ] = {}
        self._replica_cbs: Dict[
            str, List[Tuple[Optional[Callable], bool]]
        ] = {}
        self.discovery_computation = DiscoveryComputation(self)

    # -- registration (sync local cache + optional publication) --------

    def register_agent(
        self, agent: str, address: Any, publish: bool = True
    ) -> None:
        with self._lock:
            self._agents[agent] = address
        if publish:
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                PublishAgentMessage(agent=agent, address=address),
                MSG_DISCOVERY,
            )

    def unregister_agent(self, agent: str, publish: bool = True) -> None:
        with self._lock:
            self._agents.pop(agent, None)
            for c in [
                c for c, a in self._computations.items() if a == agent
            ]:
                del self._computations[c]
        if publish:
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                UnpublishAgentMessage(agent=agent),
                MSG_DISCOVERY,
            )

    def register_computation(
        self,
        computation: str,
        agent: Optional[str] = None,
        address: Any = None,
        publish: bool = True,
    ) -> None:
        agent = agent or self.agent_name
        address = address if address is not None else self.own_address
        with self._lock:
            self._computations[computation] = agent
            if address is not None:
                self._agents.setdefault(agent, address)
        if publish:
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                PublishComputationMessage(
                    computation=computation, agent=agent, address=address
                ),
                MSG_DISCOVERY,
            )

    def unregister_computation(
        self, computation: str, publish: bool = True
    ) -> None:
        with self._lock:
            self._computations.pop(computation, None)
        if publish:
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                UnpublishComputationMessage(computation=computation),
                MSG_DISCOVERY,
            )

    def register_replica(self, replica: str, agent: Optional[str] = None):
        agent = agent or self.agent_name
        with self._lock:
            self._replicas.setdefault(replica, set()).add(agent)
        self.discovery_computation.post_msg(
            DIRECTORY_COMP_NAME,
            PublishReplicaMessage(replica=replica, agent=agent),
            MSG_DISCOVERY,
        )

    def unregister_replica(self, replica: str, agent: Optional[str] = None):
        agent = agent or self.agent_name
        with self._lock:
            self._replicas.get(replica, set()).discard(agent)
        self.discovery_computation.post_msg(
            DIRECTORY_COMP_NAME,
            UnpublishReplicaMessage(replica=replica, agent=agent),
            MSG_DISCOVERY,
        )

    # -- queries -------------------------------------------------------

    def agents(self) -> List[str]:
        with self._lock:
            return list(self._agents)

    def agent_address(self, agent: str) -> Any:
        with self._lock:
            try:
                return self._agents[agent]
            except KeyError:
                raise UnknownAgent(agent) from None

    def computation_agent(self, computation: str) -> str:
        with self._lock:
            try:
                return self._computations[computation]
            except KeyError:
                raise UnknownComputation(computation) from None

    def agent_computations(self, agent: str) -> List[str]:
        with self._lock:
            return [c for c, a in self._computations.items() if a == agent]

    def computations(self) -> List[str]:
        with self._lock:
            return list(self._computations)

    def replica_agents(self, replica: str) -> Set[str]:
        with self._lock:
            return set(self._replicas.get(replica, set()))

    # -- subscriptions -------------------------------------------------

    def subscribe_all_agents(
        self, cb: Optional[Callable] = None, one_shot: bool = False
    ) -> None:
        '''``one_shot``: the callback fires for the first event only,
        then auto-removes (pyDCOP discovery.py one-shot
        subscriptions).'''
        with self._lock:
            self._agent_cbs.append((cb, one_shot if cb else False))
            # the post stays inside the lock: posting after release lets
            # a concurrent unsubscribe's directory message overtake this
            # one, leaving live local records with no directory pushes
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                SubscribeMessage(kind="agent", name=None, subscribe=True),
                MSG_DISCOVERY,
            )

    def unsubscribe_all_agents(self, cb: Optional[Callable] = None) -> None:
        '''Remove ``cb`` (or every callback when None); the directory
        stops pushing agent events once no callback remains.'''
        with self._lock:
            existed = bool(self._agent_cbs)
            self._agent_cbs = (
                [] if cb is None
                else [rec for rec in self._agent_cbs if rec[0] is not cb]
            )
            if existed and not self._agent_cbs:
                self.discovery_computation.post_msg(
                    DIRECTORY_COMP_NAME,
                    SubscribeMessage(
                        kind="agent", name=None, subscribe=False
                    ),
                    MSG_DISCOVERY,
                )

    def subscribe_computation(
        self,
        computation: str,
        cb: Optional[Callable] = None,
        one_shot: bool = False,
    ) -> None:
        with self._lock:
            self._computation_cbs.setdefault(computation, []).append(
                (cb, one_shot if cb else False)
            )
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                SubscribeMessage(
                    kind="computation", name=computation, subscribe=True
                ),
                MSG_DISCOVERY,
            )

    def unsubscribe_computation(
        self, computation: str, cb: Optional[Callable] = None
    ) -> None:
        with self._lock:
            cbs = self._computation_cbs.get(computation, [])
            existed = bool(cbs)
            cbs = [] if cb is None else [r for r in cbs if r[0] is not cb]
            if cbs:
                self._computation_cbs[computation] = cbs
            else:
                self._computation_cbs.pop(computation, None)
            if existed and not cbs:
                self.discovery_computation.post_msg(
                    DIRECTORY_COMP_NAME,
                    SubscribeMessage(
                        kind="computation", name=computation,
                        subscribe=False,
                    ),
                    MSG_DISCOVERY,
                )

    def subscribe_replica(
        self,
        replica: str,
        cb: Optional[Callable] = None,
        one_shot: bool = False,
    ) -> None:
        with self._lock:
            self._replica_cbs.setdefault(replica, []).append(
                (cb, one_shot if cb else False)
            )
            self.discovery_computation.post_msg(
                DIRECTORY_COMP_NAME,
                SubscribeMessage(
                    kind="replica", name=replica, subscribe=True
                ),
                MSG_DISCOVERY,
            )

    def unsubscribe_replica(
        self, replica: str, cb: Optional[Callable] = None
    ) -> None:
        with self._lock:
            cbs = self._replica_cbs.get(replica, [])
            existed = bool(cbs)
            cbs = [] if cb is None else [r for r in cbs if r[0] is not cb]
            if cbs:
                self._replica_cbs[replica] = cbs
            else:
                self._replica_cbs.pop(replica, None)
            if existed and not cbs:
                self.discovery_computation.post_msg(
                    DIRECTORY_COMP_NAME,
                    SubscribeMessage(
                        kind="replica", name=replica, subscribe=False
                    ),
                    MSG_DISCOVERY,
                )

    def _fire(self, kind: str, name: Optional[str], *event) -> None:
        '''Invoke subscription callbacks for one event.

        One-shot records are removed after their first event; when that
        leaves no records at all, the subscription is torn down exactly
        like unsubscribe_* (key dropped, directory told to stop pushing)
        so a one-shot subscriber does not leak directory traffic.  The
        teardown post happens INSIDE the lock, serialized with the
        record mutation: posted after release, a concurrent subscribe_*
        could append a record and post its subscribe first, and the
        late unsubscribe would silently stop directory pushes while a
        live local record exists.  Callbacks still run OUTSIDE the lock
        (a callback may re-subscribe).'''
        with self._lock:
            if kind == "agent":
                cbs = self._agent_cbs
            elif kind == "computation":
                cbs = self._computation_cbs.get(name, [])
            else:
                cbs = self._replica_cbs.get(name, [])
            to_call = [rec[0] for rec in cbs if rec[0] is not None]
            remaining = [rec for rec in cbs if not rec[1]]
            if kind == "agent":
                self._agent_cbs = remaining
            elif kind == "computation":
                if remaining:
                    self._computation_cbs[name] = remaining
                else:
                    self._computation_cbs.pop(name, None)
            else:
                if remaining:
                    self._replica_cbs[name] = remaining
                else:
                    self._replica_cbs.pop(name, None)
            if cbs and not remaining:
                self.discovery_computation.post_msg(
                    DIRECTORY_COMP_NAME,
                    SubscribeMessage(
                        kind=kind, name=name, subscribe=False
                    ),
                    MSG_DISCOVERY,
                )
        for cb in to_call:
            cb(*event)

    # -- cache updates from the discovery computation ------------------

    def _cache_agent(self, agent: str, address: Any) -> None:
        with self._lock:
            known = agent in self._agents
            self._agents[agent] = address
        if not known:
            self._fire("agent", None, "agent_added", agent, address)

    def _uncache_agent(self, agent: str) -> None:
        with self._lock:
            existed = self._agents.pop(agent, None) is not None
        if existed:
            self._fire("agent", None, "agent_removed", agent, None)

    def _cache_computation(
        self, computation: str, agent: str, address: Any
    ) -> None:
        with self._lock:
            self._computations[computation] = agent
            if address is not None:
                self._agents.setdefault(agent, address)
        self._fire(
            "computation", computation,
            "computation_added", computation, agent,
        )

    def _uncache_computation(self, computation: str) -> None:
        with self._lock:
            self._computations.pop(computation, None)
        self._fire(
            "computation", computation,
            "computation_removed", computation, None,
        )

    def _cache_replica(self, replica: str, agent: str, added: bool) -> None:
        with self._lock:
            if added:
                self._replicas.setdefault(replica, set()).add(agent)
            else:
                self._replicas.get(replica, set()).discard(agent)
        self._fire(
            "replica", replica,
            "replica_added" if added else "replica_removed", replica, agent,
        )
