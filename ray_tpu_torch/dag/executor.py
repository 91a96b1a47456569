"""Resident per-stage executor loops: the actor half of compiled graphs.

The counterpart of ray_tpu's ``dag/executor.py``. After compile, every
(dag_id, stage) on an actor gets a daemon ``StageLoop`` thread that takes
sequence numbers strictly in order: pop every input edge for seq k, run
the bound method under the actor's one lock (the lock its ordinary calls
take, so an actor stays single-threaded while stages on DIFFERENT actors
pipeline), push every output edge. The steady state is pure channel push
and pop: no message to or from the driver.

Actor-side device pops wait in short slices (``_POP_SLICE_S``), so a
stopped loop ends promptly. The ``DagRuntime`` of a graph is built by the
actor process's ``dag_register`` message (``_private.local_tasks``); a
graph compiled with ``quantize_wire`` gives its device edges the codec and
one ``ErrorFeedback`` an actor, as the reference's executor does.
"""

from __future__ import annotations

import copy
import itertools
import threading
import traceback

from ray_tpu_torch._private.local_tasks import TaskError
from ray_tpu_torch.dag import channel as shm
from ray_tpu_torch.dag.channels import (
    ChannelClosedError,
    DeviceChannel,
    DeviceGroup,
    ShmChannel,
    join_store,
)

_POP_SLICE_S = 0.5


class SeqBuffer:
    """Thread-safe in-order mailbox feeding one input slot (local and
    socket edges; shm and device edges pop their channel directly)."""

    def __init__(self):
        self._items: dict[int, object] = {}
        self._cv = threading.Condition()

    def put(self, seq: int, value) -> None:
        with self._cv:
            self._items[seq] = value
            self._cv.notify_all()

    def pop(self, seq: int, stop) -> object:
        with self._cv:
            while seq not in self._items:
                if stop():
                    raise ChannelClosedError("stage loop stopped")
                self._cv.wait(timeout=0.1)
            return self._items.pop(seq)

    def wake(self) -> None:
        with self._cv:
            self._cv.notify_all()


def private_copy(value):
    """A same-actor edge's copy barrier: the serialize round trip (host
    values), or a deep copy where the value holds CUDA tensors."""
    try:
        return shm.deserialize(shm.serialize(value), zero_copy=False)
    except TypeError:
        return copy.deepcopy(value)


class StageLoop(threading.Thread):
    """One stage's resident loop: in-order pop -> compute -> push."""

    def __init__(self, *, dag_id: str, stage: dict, store, group, run_stage,
                 deliver_local, send_socket, park_output, epoch: int = 0,
                 start_seq: int = 0, wire_cfg=None, ef=None):
        super().__init__(daemon=True, name=f"rtdag-{dag_id}-n{stage['node']}")
        self.dag_id = dag_id
        self.stage = stage
        self.start_seq = start_seq
        self._stop = threading.Event()
        self._run_stage = run_stage
        self._deliver_local = deliver_local
        self._send_socket = send_socket
        self._park_output = park_output
        depth = stage.get("depth", 8)

        def device(edge, role):
            return DeviceChannel(group, edge["peer_rank"], src=edge["src"], dst=edge["dst"],
                                 slot=edge["slot_id"], epoch=epoch, depth=depth, role=role,
                                 wire_cfg=wire_cfg, ef=ef)

        # Input poppers, in declared slot order (== method arg order).
        self._in_pops: list[tuple[str, str, object]] = []
        self._buffers: dict[str, SeqBuffer] = {}
        for edge in stage.get("in_edges", ()):
            fam = edge["family"]
            if fam == "shm":
                chan = ShmChannel(store, edge["channel"], depth, epoch=epoch, group=dag_id)
            elif fam == "device":
                chan = device(edge, "consumer")
            else:  # local / socket: fed via feed()
                chan = self._buffers.setdefault(edge["slot"], SeqBuffer())
            self._in_pops.append((edge["slot"], fam, chan))
        # Output channels, keyed by (node, slot) for downstream edges.
        self._down_chans: dict[tuple, object] = {}
        for edge in stage.get("downstream", ()):
            key = (edge["node"], edge["slot"])
            if edge["family"] == "shm":
                self._down_chans[key] = ShmChannel(store, edge["channel"], depth, epoch=epoch,
                                                   group=dag_id)
            elif edge["family"] == "device":
                self._down_chans[key] = device(edge, "producer")
        # Output edges to the driver (a stage may back several
        # MultiOutputNode members).
        self._out_chans: list[tuple[dict, object]] = []
        for out in stage.get("outs", ()):
            if out["family"] == "shm":
                chan = ShmChannel(store, out["channel"], depth, epoch=epoch, group=dag_id)
            elif out["family"] == "device":
                chan = device(out, "producer")
            else:  # socket: parked here, pulled by dag_pop
                chan = None
            self._out_chans.append((out, chan))

    # -- control ---------------------------------------------------------
    def feed(self, slot: str, seq: int, value) -> None:
        buf = self._buffers.get(slot)
        if buf is None:
            raise KeyError(f"{self.name}: slot {slot!r} is not a buffered edge")
        buf.put(seq, value)

    def stop(self) -> None:
        self._stop.set()
        for buf in self._buffers.values():
            buf.wake()

    def stopped(self) -> bool:
        return self._stop.is_set()

    def free_slots(self) -> None:
        """Consumer-owned shm ring slots (this stage's input edges)."""
        for _, fam, chan in self._in_pops:
            if fam == "shm":
                chan.free_slots()

    def device_links(self) -> list:
        """The (peer, tag)s this stage's device ends send on."""
        chans = [c for _, fam, c in self._in_pops if fam == "device"]
        chans += [c for c in self._down_chans.values() if isinstance(c, DeviceChannel)]
        chans += [c for _, c in self._out_chans if isinstance(c, DeviceChannel)]
        return [link for c in chans for link in c.links()]

    # -- per-edge ops ----------------------------------------------------
    def _pop_input(self, fam: str, chan, seq: int):
        if fam == "shm":
            return chan.pop(seq, timeout=None, stop=self.stopped)
        if fam == "device":
            while True:
                try:
                    return chan.pop_edge(timeout=_POP_SLICE_S, stop=self.stopped)
                except TimeoutError:
                    continue
        return chan.pop(seq, stop=self.stopped)  # SeqBuffer

    def _push_downstream(self, edge, seq: int, result, cache: dict) -> None:
        fam = edge["family"]
        if fam == "local":
            self._deliver_local(edge["node"], edge["slot"], seq, private_copy(result))
        elif fam == "shm":
            if "parts" not in cache:
                cache["parts"], cache["total"] = shm.serialize_parts(result)
            self._down_chans[(edge["node"], edge["slot"])].push_parts(
                seq, cache["parts"], cache["total"], stop=self.stopped)
        elif fam == "device":
            self._down_chans[(edge["node"], edge["slot"])].push_edge(result, stop=self.stopped)
        else:  # socket
            if "raw" not in cache:
                cache["raw"] = shm.serialize(result)
            self._send_socket(edge, seq, cache["raw"])

    # -- main loop -------------------------------------------------------
    def run(self) -> None:
        stage = self.stage
        try:
            # A post-recovery loop starts at the replay base: the driver
            # re-pushes every retained seq and each stage recomputes from
            # there (the driver's readers drop the duplicates).
            for seq in itertools.count(self.start_seq):
                if self.stopped():
                    return
                args, err = [], None
                for _, fam, chan in self._in_pops:
                    value = self._pop_input(fam, chan, seq)
                    if err is None and isinstance(value, TaskError):
                        err = value
                    args.append(value)
                if err is not None:
                    result = err  # skip compute, forward the failure
                else:
                    try:
                        result = self._run_stage(stage["method"], args)
                    except Exception as exc:
                        result = TaskError(stage["method"], f"{type(exc).__name__}: {exc}",
                                           traceback.format_exc())
                cache: dict = {}
                for edge in stage.get("downstream", ()):
                    self._push_downstream(edge, seq, result, cache)
                for out, chan in self._out_chans:
                    if chan is None:
                        self._park_output(seq, result)
                    elif out["family"] == "shm":
                        chan.push(seq, result, stop=self.stopped)
                    else:
                        chan.push_edge(result, stop=self.stopped)
        except ChannelClosedError:
            return
        except Exception:
            if not self.stopped():
                traceback.print_exc()


class DagRuntime:
    """What one actor holds for one graph: its membership in the graph's
    device group (when the graph has device edges), the resident
    StageLoops, and the parked results of a socket-family output edge."""

    def __init__(self, *, dag_id: str, payload: dict, run_stage, send_socket):
        self.dag_id = dag_id
        self.epoch = int(payload.get("epoch", 0))
        self._send_socket_fn = send_socket
        self._results: dict[int, object] = {}
        self._cv = threading.Condition()
        self._store = shm.SlotStore(payload["store"])
        self._group = None
        gspec = payload.get("group")
        if gspec:
            store = join_store(gspec["port"])
            self._group = DeviceGroup(store, gspec["name"], gspec["rank"], gspec["world_size"])
        wire_cfg = ef = None
        if payload.get("wire_quant"):
            from ray_tpu_torch.util.collective.quantization import (
                CollectiveConfig, ErrorFeedback,
            )

            wire_cfg = CollectiveConfig(
                quantize_activations=payload["wire_quant"]).activation_wire_config()
            ef = ErrorFeedback()
        self._loops = [
            StageLoop(dag_id=dag_id, stage=stage, store=self._store, group=self._group,
                      run_stage=run_stage, deliver_local=self._deliver_local,
                      send_socket=self._send_socket, park_output=self._park_output,
                      epoch=self.epoch, start_seq=payload.get("start_seq", 0),
                      wire_cfg=wire_cfg, ef=ef)
            for stage in payload["stages"]
        ]
        for loop in self._loops:
            loop.start()

    # -- inbound ---------------------------------------------------------
    def feed(self, node: int, slot: str, seq: int, value) -> None:
        for loop in self._loops:
            if loop.stage["node"] == node:
                loop.feed(slot, seq, value)
                return
        raise KeyError(f"dag {self.dag_id}: stage {node} not on this actor")

    # -- StageLoop callbacks ---------------------------------------------
    def _deliver_local(self, node: int, slot: str, seq: int, value) -> None:
        self.feed(node, slot, seq, value)

    def _send_socket(self, edge: dict, seq: int, raw) -> None:
        reply = self._send_socket_fn(edge["address"], {
            "dag_id": self.dag_id, "node": edge["node"], "slot": edge["slot"],
            "seq": seq, "value": raw, "epoch": self.epoch})
        if (reply or {}).get("status") != "ok":
            raise RuntimeError(f"dag_push to stage {edge['node']} failed: {reply!r}")

    def _park_output(self, seq: int, result) -> None:
        with self._cv:
            self._results[seq] = result
            self._cv.notify_all()

    # -- outbound (socket output edge) -----------------------------------
    def pop(self, seq: int, timeout: float) -> dict:
        with self._cv:
            if not self._cv.wait_for(lambda: seq in self._results, timeout):
                return {"status": "timeout"}
            result = self._results.pop(seq)
        return {"status": "ok", "value": shm.serialize(result)}

    # -- teardown --------------------------------------------------------
    def stop(self) -> None:
        """Stops every loop, frees consumer-owned ring slots and closes this
        actor's ends of the device group."""
        for loop in self._loops:
            loop.stop()
        for loop in self._loops:
            loop.join(timeout=5)
        for loop in self._loops:
            loop.free_slots()
        with self._cv:
            self._results.clear()
        if self._group is not None:
            self._group.close_links([link for loop in self._loops
                                     for link in loop.device_links()])
            self._group = None
