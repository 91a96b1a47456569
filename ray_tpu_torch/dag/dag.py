"""Compiled dataflow graphs on pre-opened channels.

The counterpart of ray_tpu's ``dag/dag.py`` (``InputNode``, ``DAGNode``,
``MultiOutputNode``, ``experimental_compile``), on the port's local actors
(``_private.local_tasks``): a static graph of actor method calls is
compiled ONCE (the placement plan pins every actor and assigns its
device-plane rank, every edge's channel is opened, every actor starts a
resident loop a stage), and each ``execute()`` then flows actor to actor
over those channels with no message to any actor.

Channel families (``dag/channels.py``), chosen per edge by the plan: the
shm ring (co-located host payloads), the device group (gloo for host
values, CUDA IPC for a card's tensors between processes that see the
card, NCCL between cards), in-process delivery (same-actor edges) and the
socket fallback. Bounded in-flight ``execute()`` pipelining gets its
backpressure from the ring depth.

    with InputNode() as inp:
        x = worker_a.preprocess.bind(inp)
        out = worker_b.infer.bind(x)
    dag = out.experimental_compile()      # or (channel="device")
    ref = dag.execute(batch)              # non-blocking, no actor message
    result = ref.get(timeout=60)
    dag.close()                           # drain, free, stop the loops

``quantize_wire`` ("int8" or "fp8") block-scale quantizes the float
numpy arrays that device edges carry, with an error-feedback residual an
edge (``util.collective.quantization``), as the reference's does.
Supervised reads probe liveness every ``PROBE_INTERVAL_S``, and at once
when the comm watchdog reports a stall on one of the graph's channels
(a stall listener on the graph's id). Left out: trace contexts and
placement on more than one host (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
import weakref
from typing import Any

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.dag import channel as shm
from ray_tpu_torch.dag import placement
from ray_tpu_torch.dag.channels import (
    DeviceChannel,
    DeviceGroup,
    ShmChannel,
    host_store,
    int_tag,
)

_node_counter = itertools.count()

_CHANNEL_FAMILIES = (None, "auto", "shm", "device", "socket")

# Live compiled graphs, torn down from local_tasks.shutdown() so resident
# loops and ring slots never outlive the driver's runtime.
_LIVE_DAGS: "weakref.WeakValueDictionary[str, CompiledDAG]" = weakref.WeakValueDictionary()


class ActorDiedError(RuntimeError):
    """The actor is permanently dead (restarts exhausted or never restartable)."""


class DAGActorDiedError(ActorDiedError):
    """An actor of a compiled graph died while an execution was in flight.
    Raised from ``DAGRef.get()`` instead of a bare timeout, so a caller can
    tell "the graph is dead" from "the graph is slow"; names the dead actor
    and its device-plane rank, and the edge it was detected on (channel,
    family, epoch and the seq frontier the reader was blocked at)."""

    def __init__(self, dag_id: str, actor_id: str, rank: int, detail: str = "", *,
                 channel: str | None = None, family: str | None = None,
                 epoch: int | None = None, seq: int | None = None):
        self.dag_id, self.actor_id, self.rank, self.detail = dag_id, actor_id, rank, detail
        self.channel, self.family, self.epoch, self.seq = channel, family, epoch, seq
        message = (f"compiled DAG {dag_id}: actor {actor_id} (dag rank {rank}) "
                   "died with executions in flight")
        if channel is not None:
            message += (f" [detected on {family or '?'} channel {channel}"
                        f" epoch={epoch} seq frontier={seq}]")
        if detail:
            message += f": {detail}"
        super().__init__(message)

    def __reduce__(self):
        # The third element updates __dict__ on unpickle, so the edge
        # evidence survives the wire.
        return (DAGActorDiedError, (self.dag_id, self.actor_id, self.rank, self.detail),
                {"channel": self.channel, "family": self.family, "epoch": self.epoch,
                 "seq": self.seq})


def shutdown_all() -> None:
    """Tears down every live compiled graph and removes the slot store."""
    for dag in list(_LIVE_DAGS.values()):
        try:
            dag.teardown()
        except Exception:  # rtlint: disable=swallowed-exception - shutdown must proceed past a dead graph
            pass
    shm.remove_local_store()


class DAGNode:
    def __init__(self):
        self.node_id = next(_node_counter)
        self.channel_hint: str | None = None

    def with_channel(self, family: str) -> "DAGNode":
        """Per-node channel-family hint for the edges that feed this node
        (and its output edge when it is a graph output): "shm", "device",
        "socket", or "auto" (clear the hint)."""
        if family not in ("auto", "shm", "device", "socket"):
            raise ValueError(f"unknown channel family {family!r} "
                             "(use 'auto', 'shm', 'device', or 'socket')")
        self.channel_hint = None if family == "auto" else family
        return self

    def experimental_compile(self, channel: str | None = None,
                             quantize_wire: str | None = None, supervise: bool = False,
                             max_recoveries: int = 3) -> "CompiledDAG":
        return CompiledDAG(self, channel=channel, quantize_wire=quantize_wire,
                           supervise=supervise, max_recoveries=max_recoveries)

    def _upstream(self) -> list["DAGNode"]:
        return []


class InputNode(DAGNode):
    """The graph's input placeholder (``with InputNode() as inp:``)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


def _interpret(node: "DAGNode", input_values: tuple, memo: dict) -> Any:
    """Interpreted (uncompiled) execution: one actor call a node, memoized
    so a fan-out node runs once."""
    if node.node_id in memo:
        return memo[node.node_id]
    if isinstance(node, InputNode):
        value = input_values[0] if len(input_values) == 1 else input_values
    else:
        args = [_interpret(a, input_values, memo) if isinstance(a, DAGNode) else a
                for a in node.args]
        method = getattr(node.actor, node.method_name)
        value = local_tasks.get(method.remote(*args), timeout=300)
    memo[node.node_id] = value
    return value


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: tuple):
        super().__init__()
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args

    def _upstream(self) -> list[DAGNode]:
        return [a for a in self.args if isinstance(a, DAGNode)]

    def execute(self, *input_values) -> Any:
        """Interpreted (uncompiled) execution through ordinary actor calls."""
        return _interpret(self, input_values, {})


class MultiOutputNode(DAGNode):
    """Marks several graph nodes as the graph's outputs: ``execute().get()``
    returns their values as a list, each on its own output channel."""

    def __init__(self, nodes):
        super().__init__()
        self.nodes = list(nodes)
        if not self.nodes:
            raise ValueError("MultiOutputNode needs at least one node")
        for n in self.nodes:
            if not isinstance(n, ClassMethodNode):
                raise ValueError("MultiOutputNode members must be actor method nodes "
                                 f"(got {type(n).__name__})")

    def _upstream(self) -> list[DAGNode]:
        return list(self.nodes)

    def execute(self, *input_values) -> list:
        memo: dict = {}
        return [_interpret(n, input_values, memo) for n in self.nodes]


class DAGRef:
    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: float = 300.0) -> Any:
        return self._dag._pop(self._seq, timeout)


# Supervised driver pops run in short slices so the supervisor can probe
# the actors' liveness while blocked.
_DRIVER_POP_SLICE_S = 0.5


class _OutReader:
    """The driver's in-order consumer of ONE output edge. Channel seqs are
    strictly ordered, so an out-of-order get() buffers the earlier seqs it
    drains on the way.

    ``_next`` is the CHANNEL cursor (next seq to pop off the wire);
    ``_discard_below`` the replay-dedup frontier. After a recovery the
    supervisor refits this reader onto the re-opened epoch and rewinds the
    cursor to the replay base: replayed frames below the old cursor are
    popped and dropped, so the caller never sees a duplicate."""

    def __init__(self, dag: "CompiledDAG", actor_id: str, out: dict, chan):
        self._dag = dag
        self._actor_id = actor_id
        self._out = out
        self._chan = chan
        self._next = 0
        self._discard_below = 0
        self._ready: dict[int, Any] = {}

    def refit(self, out: dict, chan, start_seq: int) -> None:
        self._out = out
        self._chan = chan
        self._discard_below = max(self._discard_below, self._next)
        self._next = start_seq

    def read(self, seq: int, deadline: float) -> Any:
        if self._out["family"] == "socket":
            return self._socket_pop(seq, deadline)
        while seq not in self._ready:
            self.drain_one(deadline)
        return self._ready.pop(seq)

    def drain_one(self, deadline: float) -> None:
        """Pops the next channel seq into the ready buffer (or discards it
        as a replay duplicate); supervised graphs pop in slices and probe
        liveness between them."""
        sliced = self._dag._supervise
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"dag output seq={self._next} not ready")
            slice_s = min(remaining, _DRIVER_POP_SLICE_S) if sliced else remaining
            try:
                if self._out["family"] == "shm":
                    value = self._chan.pop(self._next, timeout=slice_s)
                else:
                    value = self._chan.pop_edge(timeout=slice_s)
                break
            except TimeoutError:
                if not sliced or slice_s >= remaining:
                    raise
                # Raises a typed death error if an actor is gone; a
                # slow-but-alive graph keeps waiting.
                self._dag._maybe_probe(self._out, self._next)
        if self._next >= self._discard_below:
            self._ready[self._next] = value
        else:
            self._dag.replay_discards += 1
        self._next += 1

    def _socket_pop(self, seq: int, deadline: float) -> Any:
        remaining = max(0.1, deadline - time.monotonic())
        resp = self._dag._call_actor(
            self._actor_id, "dag_pop",
            {"dag_id": self._dag.dag_id, "seq": seq, "timeout": remaining},
            timeout=remaining + 15)
        if resp.get("status") == "timeout":
            raise TimeoutError(f"dag output seq={seq} not ready")
        if resp.get("status") != "ok":
            raise RuntimeError(f"dag_pop failed: {resp.get('error', resp)!r}")
        return shm.deserialize(resp["value"], zero_copy=False)


class CompiledDAG:
    """A compiled graph: placement-planned stages, pre-opened channels on
    every edge, resident actor loops, bounded in-flight pipelining with
    ring-depth backpressure, and a real close()."""

    CHANNEL_DEPTH = 8  # ring slots an edge = the most executions in flight

    # A supervised reader blocked on a late result probes liveness this often.
    PROBE_INTERVAL_S = 2.0

    def __init__(self, output_node: DAGNode, *, channel: str | None = None,
                 quantize_wire: str | None = None, supervise: bool = False,
                 max_recoveries: int = 3):
        if isinstance(output_node, InputNode):
            raise ValueError("cannot compile a bare InputNode")
        if channel not in _CHANNEL_FAMILIES:
            raise ValueError(f"unknown channel family {channel!r} "
                             f"(use one of {_CHANNEL_FAMILIES[1:]})")
        self._quantize_wire = quantize_wire
        self._wire_cfg, self._wire_ef = self._make_wire_codec()
        self.dag_id = f"dag-{uuid.uuid4().hex[:8]}"
        self.output_node = output_node
        self._channel_override = None if channel == "auto" else channel
        self._out_nodes = (list(output_node.nodes) if isinstance(output_node, MultiOutputNode)
                           else [output_node])
        self._multi_output = isinstance(output_node, MultiOutputNode)
        self._submitted = 0  # next execute() seq
        self._store = shm.local_store()
        self._stages: dict[int, dict] = {}  # node_id -> stage spec
        self._input_targets: list[dict] = []
        self._out_readers: list[_OutReader] = []
        self._all_shm_bases: list[str] = []
        self._group: DeviceGroup | None = None
        self._torn_down = False
        self._inflight: set[int] = set()
        # -- self-healing state (costs nothing until a failure) ----------
        self._supervise = bool(supervise)
        self._max_recoveries = int(max_recoveries)
        self._epoch = 0
        self.recoveries = 0
        self.replay_discards = 0
        self.last_recovery: dict | None = None
        # Each in-flight input is retained until its outputs complete (or,
        # with snapshot hooks, until the next committed snapshot): the
        # replay log a recovery re-feeds from.
        self._retained: dict[int, Any] = {}
        self._snapshots: dict[str, Any] | None = None
        self._snapshot_base: int | None = None
        self._last_probe_ts = 0.0
        # A watchdog stall on any of this graph's channels (any epoch: the
        # groups' names share the graph's id) wakes the next probe at once.
        # The callback closes over the event, not the graph.
        self._stall_event = threading.Event()
        self._stall_cb = None
        if self._supervise:
            from ray_tpu_torch.util.collective import flight

            evt = self._stall_event
            self._stall_cb = lambda event: evt.set()
            flight.register_stall_listener(self.dag_id, self._stall_cb)
        self._actor_ids: list[str] = []
        self._compile()
        _LIVE_DAGS[self.dag_id] = self

    # -- graph lowering --------------------------------------------------
    def _compile(self) -> None:
        nodes: dict[int, DAGNode] = {}

        def walk(node: DAGNode):
            if node.node_id in nodes:
                return
            nodes[node.node_id] = node
            for up in node._upstream():
                walk(up)

        walk(self.output_node)
        method_nodes = sorted((n for n in nodes.values() if isinstance(n, ClassMethodNode)),
                              key=lambda n: n.node_id)
        if not method_nodes:
            raise ValueError("DAG has no actor method nodes")
        self._method_nodes = method_nodes
        for node in method_nodes:
            for arg in node.args:
                if not isinstance(arg, DAGNode):
                    raise ValueError(
                        "compiled DAG args must be upstream nodes or the InputNode (got a "
                        "constant; close over it in the actor instead)")
        # Stable out-edge dst ids: allocated once so device tags stay the
        # same across recovery re-lowers.
        self._out_dst_ids = [next(_node_counter) for _ in self._out_nodes]
        ordered_actors: list[str] = []
        for node in method_nodes:
            aid = node.actor._actor_id
            if aid not in ordered_actors:
                ordered_actors.append(aid)
        self._actor_ids = ordered_actors
        plan = placement.PlacementPlan.resolve(ordered_actors)
        self._plan = plan
        self._lower(plan)
        self._register(plan, need_group="device" in self._families, epoch=0, start_seq=0)
        self._open_driver_channels(plan, start_seq=0)

    def _lower(self, plan: placement.PlacementPlan) -> None:
        """Lowers the graph onto a placement plan: stage specs, edge
        families, channel names. A pure function of (graph, plan), run
        again by a recovery."""
        self._stages = {}
        self._input_targets = []
        self._all_shm_bases = []
        for node in self._method_nodes:
            self._stages[node.node_id] = {
                "node": node.node_id, "actor_id": node.actor._actor_id,
                "method": node.method_name,
                "slots": [f"a{i}" for i, a in enumerate(node.args) if isinstance(a, DAGNode)],
                "in_edges": [], "downstream": [], "outs": [], "is_output": False,
                "depth": self.CHANNEL_DEPTH,
            }
        families: set[str] = set()
        device_links: dict[tuple, set] = {}

        def device_tag(src_rank, dst_rank, src, dst, slot):
            tag = f"dagch:p{self._epoch}:e{src}:{dst}:{slot}"
            pair = device_links.setdefault(tuple(sorted((src_rank, dst_rank))), set())
            for t in (int_tag(tag), int_tag("dagack" + tag[5:])):
                if t in pair:
                    raise ValueError(f"{self.dag_id}: device tag {tag} collides with another "
                                     "edge of the same ranks")
                pair.add(t)
            return tag

        for node in self._method_nodes:
            stage = self._stages[node.node_id]
            dst_aid = stage["actor_id"]
            for i, arg in enumerate(node.args):
                slot = f"a{i}"
                if isinstance(arg, InputNode):
                    fam = placement.edge_family(plan, None, dst_aid, node.channel_hint,
                                                self._channel_override)
                    families.add(fam)
                    edge = {"slot": slot, "family": fam, "src": arg.node_id,
                            "dst": node.node_id, "slot_id": i}
                    target = {"actor_id": dst_aid, "node": node.node_id, "slot": slot,
                              "family": fam, "channel": None, "src": arg.node_id,
                              "dst": node.node_id, "slot_id": i, "chan": None}
                    if fam == "shm":
                        base = f"dagch-{self.dag_id}-in-{node.node_id}-{slot}"
                        edge["channel"] = target["channel"] = base
                        self._all_shm_bases.append(base)
                    elif fam == "device":
                        edge["peer_rank"] = 0
                        target["channel"] = device_tag(0, plan.rank_of(dst_aid), arg.node_id,
                                                       node.node_id, i)
                    stage["in_edges"].append(edge)
                    self._input_targets.append(target)
                else:  # ClassMethodNode
                    src_stage = self._stages[arg.node_id]
                    src_aid = src_stage["actor_id"]
                    fam = placement.edge_family(plan, src_aid, dst_aid, node.channel_hint,
                                                self._channel_override)
                    families.add(fam)
                    common = {"src": arg.node_id, "dst": node.node_id, "slot_id": i}
                    in_edge = {"slot": slot, "family": fam, **common}
                    down = {"actor_id": dst_aid, "node": node.node_id, "slot": slot,
                            "family": fam, **common}
                    if fam == "shm":
                        base = f"dagch-{self.dag_id}-e{arg.node_id}-{node.node_id}-{slot}"
                        in_edge["channel"] = down["channel"] = base
                        self._all_shm_bases.append(base)
                    elif fam == "device":
                        device_tag(plan.rank_of(src_aid), plan.rank_of(dst_aid), arg.node_id,
                                   node.node_id, i)
                        in_edge["peer_rank"] = plan.rank_of(src_aid)
                        down["peer_rank"] = plan.rank_of(dst_aid)
                    elif fam == "socket":
                        down["address"] = plan.actors[dst_aid]["address"]
                    src_stage["downstream"].append(down)
                    stage["in_edges"].append(in_edge)
        out_specs: list[tuple[str, dict]] = []
        for k, out_node in enumerate(self._out_nodes):
            stage = self._stages[out_node.node_id]
            stage["is_output"] = True
            aid = stage["actor_id"]
            fam = placement.edge_family(plan, aid, None, out_node.channel_hint,
                                        self._channel_override)
            families.add(fam)
            out = {"family": fam, "src": out_node.node_id, "dst": self._out_dst_ids[k],
                   "slot_id": 0}
            if fam == "shm":
                out["channel"] = f"dagch-{self.dag_id}-out-{k}"
                self._all_shm_bases.append(out["channel"])
            elif fam == "device":
                out["peer_rank"] = 0
                device_tag(plan.rank_of(aid), 0, out["src"], out["dst"], 0)
            stage["outs"].append(out)
            out_specs.append((aid, out))
        if self._multi_output and sum(1 for _, o in out_specs if o["family"] == "socket") > 1:
            raise ValueError("the socket fallback supports a single output edge; use shm or "
                             "device channels for MultiOutputNode graphs")
        self._out_specs = out_specs
        self._families = families

    def _open_driver_channels(self, plan: placement.PlacementPlan, start_seq: int) -> None:
        """Builds (or, on recovery, re-builds) the driver's ends of every
        input and output edge at the current epoch. Existing readers are
        refitted in place so their delivery state survives the epoch bump."""
        for t in self._input_targets:
            if t["family"] == "shm":
                t["chan"] = ShmChannel(self._store, t["channel"], self.CHANNEL_DEPTH,
                                       epoch=self._epoch, group=self.dag_id)
            elif t["family"] == "device":
                t["chan"] = DeviceChannel(self._group, plan.rank_of(t["actor_id"]),
                                          src=t["src"], dst=t["dst"], slot=t["slot_id"],
                                          epoch=self._epoch, depth=self.CHANNEL_DEPTH,
                                          role="producer", wire_cfg=self._wire_cfg,
                                          ef=self._wire_ef)
        refit = bool(self._out_readers)
        for i, (aid, out) in enumerate(self._out_specs):
            chan = None
            if out["family"] == "shm":
                chan = ShmChannel(self._store, out["channel"], self.CHANNEL_DEPTH,
                                  epoch=self._epoch, group=self.dag_id)
            elif out["family"] == "device":
                chan = DeviceChannel(self._group, plan.rank_of(aid), src=out["src"],
                                     dst=out["dst"], slot=out["slot_id"], epoch=self._epoch,
                                     depth=self.CHANNEL_DEPTH, role="consumer",
                                     wire_cfg=self._wire_cfg, ef=self._wire_ef)
            if refit:
                self._out_readers[i].refit(out, chan, start_seq)
            else:
                self._out_readers.append(_OutReader(self, aid, out, chan))

    def _group_name_for(self, epoch: int) -> str:
        """Per-epoch group name: a recovery's group never meets the old one."""
        return self.dag_id if epoch == 0 else f"{self.dag_id}:p{epoch}"

    def _register(self, plan: placement.PlacementPlan, need_group: bool, epoch: int,
                  start_seq: int) -> None:
        """Registers the stage bundles on every actor; with device edges,
        every actor's register blocks in the group's rendezvous until the
        driver (rank 0) builds its end here, so the registers run at once,
        each in a thread."""
        group_name = self._group_name_for(epoch)
        by_actor: dict[str, list] = {}
        for stage in self._stages.values():
            by_actor.setdefault(stage["actor_id"], []).append(stage)
        store = host_store() if need_group else None
        errors: dict[str, str] = {}

        def one(aid: str) -> None:
            try:
                resp = self._call_actor(aid, "dag_register", {
                    "dag_id": self.dag_id, "stages": by_actor[aid],
                    "depth": self.CHANNEL_DEPTH, "epoch": epoch, "start_seq": start_seq,
                    "wire_quant": self._quantize_wire,
                    "store": self._store.root,
                    "group": ({"name": group_name, "world_size": plan.world_size,
                               "rank": plan.rank_of(aid), "port": store.port}
                              if need_group else None),
                }, timeout=180)
                if (resp or {}).get("status") != "ok":
                    errors[aid] = repr(resp)
            except Exception as exc:
                errors[aid] = f"{type(exc).__name__}: {exc}"

        threads = [threading.Thread(target=one, args=(aid,), daemon=True) for aid in by_actor]
        for t in threads:
            t.start()
        if need_group:
            try:
                self._group = DeviceGroup(store, group_name, 0, plan.world_size)
            except Exception:
                for t in threads:
                    t.join(1.0)
                raise
        for t in threads:
            t.join(200)
        if errors:
            self._destroy_group()
            aid, err = next(iter(errors.items()))
            raise RuntimeError(f"dag_register failed on actor {aid}: {err}")

    # -- actor messages --------------------------------------------------
    def _call_actor(self, actor_id: str, op: str, payload: dict,
                    timeout: float = 300.0) -> dict:
        return local_tasks.actor_control(actor_id, op, payload, timeout)

    # -- execution -------------------------------------------------------
    def execute(self, value: Any) -> DAGRef:
        if self._torn_down:
            raise RuntimeError(f"{self.dag_id} is torn down")
        # Bounded in-flight executions: the rings hold CHANNEL_DEPTH seqs an
        # edge, so more un-popped executions would wedge the submitter.
        if len(self._inflight) >= self.CHANNEL_DEPTH:
            raise RuntimeError(
                f"{self.dag_id}: {len(self._inflight)} executions already in flight "
                f"(max {self.CHANNEL_DEPTH}); get() earlier results before submitting more")
        seq = self._submitted
        self._submitted += 1
        self._inflight.add(seq)
        if self._supervise:
            self._retained[seq] = value
        self._push_input(seq, value)
        return DAGRef(self, seq)

    def _push_input(self, seq: int, value: Any) -> None:
        """Pushes one input seq into every input edge (execute() and the
        supervisor's replay)."""
        parts = total = raw = None
        for target in self._input_targets:
            fam = target["family"]
            if fam == "shm":
                if parts is None:
                    parts, total = shm.serialize_parts(value)
                target["chan"].push_parts(seq, parts, total)
            elif fam == "device":
                target["chan"].push_edge(value)
            else:  # socket fallback: one message a push
                if raw is None:
                    raw = shm.serialize(value)
                resp = self._call_actor(target["actor_id"], "dag_push", {
                    "dag_id": self.dag_id, "node": target["node"], "seq": seq,
                    "slot": target["slot"], "value": raw, "epoch": self._epoch})
                if (resp or {}).get("status") == "stale_epoch":
                    raise RuntimeError(f"{self.dag_id}: dag_push rejected: the actor is at a "
                                       f"newer epoch than this driver ({self._epoch})")

    def _pop(self, seq: int, timeout: float) -> Any:
        self._inflight.discard(seq)
        deadline = time.monotonic() + timeout
        values = []
        for i in range(len(self._out_readers)):
            while True:
                try:
                    values.append(self._out_readers[i].read(seq, deadline))
                    break
                except DAGActorDiedError as err:
                    self._handle_death(err)
                    deadline = time.monotonic() + timeout  # a fresh budget for the replay
                except (TimeoutError, ConnectionError, EOFError, RuntimeError) as exc:
                    err = self._probe_death(seq, self._out_readers[i]._out)
                    if err is None:
                        if isinstance(exc, TimeoutError):
                            raise TimeoutError(
                                f"dag output seq={seq} not ready in {timeout}s") from None
                        raise
                    self._handle_death(err)
                    deadline = time.monotonic() + timeout
        self._retire(seq)
        errors = [v for v in values if isinstance(v, local_tasks.TaskError)]
        if errors:
            raise errors[0]
        return values if self._multi_output else values[0]

    def _retire(self, seq: int) -> None:
        """Drops retained inputs no recovery could replay: everything below
        the slowest reader's cursor (the snapshot commit, with hooks)."""
        if not self._retained:
            return
        floor = min(r._next for r in self._out_readers)
        if self._snapshot_base is not None:
            floor = min(floor, self._snapshot_base)
        for s in [s for s in self._retained if s < floor]:
            del self._retained[s]

    # -- supervised liveness probing -------------------------------------
    def _maybe_probe(self, out: dict, frontier: int) -> None:
        now = time.monotonic()
        stalled = self._stall_event.is_set()
        if not stalled and now - self._last_probe_ts < self.PROBE_INTERVAL_S:
            return
        self._stall_event.clear()
        self._last_probe_ts = now
        err = self._probe_death(frontier, out)
        if err is not None:
            raise err

    def _probe_death(self, frontier: int, out: dict | None = None) -> DAGActorDiedError | None:
        """Asks the actor table for every actor's state; a DEAD one becomes
        a typed death error carrying the edge evidence. None when everyone
        is alive."""
        fam = out.get("family") if out else None
        channel = None
        if out is not None:
            if fam == "shm":
                channel = out.get("channel")
            elif fam == "device":
                channel = (f"dagch:p{self._epoch}:e{out['src']}:{out['dst']}:"
                           f"{out['slot_id']}")
            else:
                channel = "dag_pop"
        for aid in self._actor_ids:
            try:
                info = local_tasks.actor_info(aid)
            except KeyError:
                continue
            if info.get("state") == "DEAD":
                return DAGActorDiedError(self.dag_id, aid, self._plan.rank_of(aid),
                                         detail=str(info.get("death_cause") or ""),
                                         channel=channel, family=fam, epoch=self._epoch,
                                         seq=frontier)
        return None

    def _handle_death(self, err: DAGActorDiedError) -> None:
        """An actor died with executions in flight: recover in place
        (supervised, budget left) or tear the graph down and re-raise."""
        if not self._supervise or self.recoveries >= self._max_recoveries:
            self._fail_cleanup()
            raise err
        from ray_tpu_torch.dag import supervisor

        try:
            supervisor.recover(self, err)
        except Exception:
            self._fail_cleanup()
            raise
        self.recoveries += 1

    def _fail_cleanup(self) -> None:
        """Failure-path teardown: every ring slot released, every loop
        stopped, the retained inputs dropped; close() is then a no-op."""
        if self._torn_down:
            return
        self._torn_down = True
        _LIVE_DAGS.pop(self.dag_id, None)
        self._inflight.clear()
        self._retained.clear()
        self._teardown_actors()
        self._destroy_group()

    # -- snapshot hooks ---------------------------------------------------
    def snapshot(self, timeout: float = 60.0) -> int:
        """Commits a stateful checkpoint: ``__dag_snapshot__`` on every actor
        that defines it, the blobs kept here, all or nothing. Needs a
        quiescent graph, so the snapshot is an exact seq frontier; a
        recovery restores hooked actors to it and replays from it. Returns
        the snapshot's base seq."""
        if self._torn_down:
            raise RuntimeError(f"{self.dag_id} is torn down")
        if self._inflight:
            raise RuntimeError(f"{self.dag_id}: snapshot() requires a quiescent graph "
                               f"({len(self._inflight)} executions in flight; get() them first)")
        blobs: dict[str, Any] = {}
        for aid in self._actor_ids:
            resp = self._call_actor(aid, "dag_snapshot", {"dag_id": self.dag_id},
                                    timeout=timeout)
            status = (resp or {}).get("status")
            if status == "no_hook":
                continue
            if status != "ok":
                raise RuntimeError(f"dag_snapshot failed on actor {aid}: {resp!r}")
            blobs[aid] = resp["blob"]
        self._snapshots = blobs
        self._snapshot_base = self._submitted
        for s in [s for s in self._retained if s < self._snapshot_base]:
            del self._retained[s]
        return self._snapshot_base

    # -- teardown ---------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Drains in-flight executions, stops the resident loops, and frees
        every ring slot. Idempotent."""
        if self._torn_down:
            return
        self._torn_down = True
        _LIVE_DAGS.pop(self.dag_id, None)
        self._retained.clear()
        # Drain admitted-but-unpopped seqs so no loop is wedged mid-push
        # when the teardown lands.
        for seq in sorted(self._inflight):
            deadline = time.monotonic() + min(5.0, timeout)
            for reader in self._out_readers:
                try:
                    reader.read(seq, deadline)
                except Exception:  # rtlint: disable=swallowed-exception - draining a dead or torn graph; slots are freed below regardless
                    pass
        self._inflight.clear()
        if self._stall_cb is not None:
            from ray_tpu_torch.util.collective import flight

            flight.unregister_stall_listener(self._stall_cb)
            self._stall_cb = None
        self._teardown_actors(timeout)
        self._destroy_group()

    def _make_wire_codec(self) -> tuple:
        """(activation wire config, the driver's ErrorFeedback) of
        ``quantize_wire``, or (None, None) for the exact wire."""
        if not self._quantize_wire:
            return None, None
        from ray_tpu_torch.util.collective.quantization import CollectiveConfig, ErrorFeedback

        cfg = CollectiveConfig(quantize_activations=self._quantize_wire)
        return cfg.activation_wire_config(), ErrorFeedback()

    def teardown(self) -> None:
        """Alias of close()."""
        self.close()

    def _teardown_actors(self, timeout: float = 10.0) -> None:
        """``dag_teardown`` to every actor at once (a dead one's timeout must
        not hold up the others), then every shm slot of this graph is
        deleted here: a dead actor leaks none of its consumer-owned slots."""
        def one(aid: str) -> None:
            try:
                self._call_actor(aid, "dag_teardown", {"dag_id": self.dag_id},
                                 timeout=timeout)
            except Exception:  # rtlint: disable=swallowed-exception - the actor may be dead; teardown is idempotent
                pass

        threads = [threading.Thread(target=one, args=(aid,), daemon=True)
                   for aid in self._actor_ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 5)
        self._free_shm_slots()

    def _free_shm_slots(self) -> None:
        for base in self._all_shm_bases:
            for i in range(self.CHANNEL_DEPTH):
                try:
                    self._store.delete(f"{base}-{i}")
                except OSError:
                    pass  # already freed

    def _driver_links(self) -> list:
        chans = [t["chan"] for t in self._input_targets if isinstance(t["chan"], DeviceChannel)]
        chans += [r._chan for r in self._out_readers if isinstance(r._chan, DeviceChannel)]
        return [link for c in chans for link in c.links()]

    def _destroy_group(self) -> None:
        """Closes the driver's ends of the device group (CLOSE on each link
        it sends on) and drops it."""
        if self._group is None:
            return
        group, self._group = self._group, None
        group.close_links(self._driver_links())

    def __del__(self):  # a dropped graph must not leak its actors' loops
        try:
            if not self._torn_down:
                self._torn_down = True
                threading.Thread(target=self._release_dropped, daemon=True).start()
        except Exception:  # rtlint: disable=swallowed-exception - __del__ during interpreter teardown
            pass

    def _release_dropped(self) -> None:
        try:
            self._teardown_actors()
            self._destroy_group()
        except Exception:  # rtlint: disable=swallowed-exception - a graph dropped at interpreter exit
            pass
