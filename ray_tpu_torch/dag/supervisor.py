"""Driver-side crash recovery for compiled graphs.

The counterpart of ray_tpu's ``dag/supervisor.py``. A supervised
CompiledDAG (``experimental_compile(supervise=True)``) that meets a
``DAGActorDiedError`` (from a liveness probe its blocked reader ran
between pop slices) calls :func:`recover` instead of raising it:

1. **Diagnose**: every DEAD actor of the graph is a victim (the error
   names at least one).
2. **Restart**: each victim gets a new process from its class and
   constructor arguments (``local_tasks.restart_actor``, idempotent by
   state), polled with full-jitter backoff until ALIVE.
3. **Quiesce**: every surviving stage loop stops (``dag_teardown``,
   idempotent, best-effort to the dead), the driver's old-epoch device
   group closes, and every old shm slot is swept. A frame that slips the
   sweep is fenced by its epoch header.
4. **Re-open**: the epoch goes up, placement is resolved again (ranks are
   stable: the same actor order), the graph is lowered again, committed
   ``__dag_snapshot__`` state goes back to every hooked actor (survivors
   roll back too: the graph restarts from ONE consistent cut), every stage
   registers at ``(epoch, start_seq)`` (a new group for the epoch), and
   the driver's channel ends re-open (readers refit in place).
5. **Replay**: every retained input from the replay base is pushed again
   in order, draining laggard readers so ring-depth backpressure cannot
   wedge a replay longer than the ring. Readers discard replayed seqs
   below their old cursors, so ``execute()`` stays exactly-once.

The steady state costs nothing: no timer, no thread, no extra message;
all of this is reached only from a failed pop (or a probe the comm
watchdog's stall listener woke early). A recovery's start and end are
notes in the comm flight ring (``dag_recovery_start`` / ``_done``, the new
epoch in the seq field, the triggering edge in the tag), as the
reference's are. Left out: the hang report the reference reads from its
controller beside its own victims (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import time

from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.dag import placement
from ray_tpu_torch.util.backoff import Backoff
from ray_tpu_torch.util.collective import flight

# How long a recovery waits for one victim to come back ALIVE.
RECOVERY_TIMEOUT_S = 120.0

# A generous ceiling a replayed seq: replayed frames flow through warm
# stages, so this only bounds a pathological wedge.
_REPLAY_DRAIN_TIMEOUT_S = 60.0


def _actor_state(actor_id: str) -> dict:
    try:
        return local_tasks.actor_info(actor_id)
    except KeyError:
        return {}


def _find_victims(dag, err) -> list[str]:
    return [aid for aid in dag._actor_ids
            if aid == err.actor_id or _actor_state(aid).get("state") == "DEAD"]


def _restart_victim(dag, actor_id: str) -> None:
    """Restarts one dead actor and waits for it to come back ALIVE."""
    resp = local_tasks.restart_actor(actor_id)
    if (resp or {}).get("status") != "ok":
        raise local_tasks.WorkerCrashedError(
            actor_id, f"{dag.dag_id}: the actor could not be restarted: {resp!r}")
    deadline = time.monotonic() + RECOVERY_TIMEOUT_S
    backoff = Backoff(initial_backoff_s=0.05, max_backoff_s=2.0)
    while True:
        # Each poll waits up to its backoff for the state to settle, and
        # returns as soon as it does.
        wait = backoff.next_delay(cap=deadline - time.monotonic())
        try:
            info = local_tasks.actor_info(actor_id, wait_ready=True, timeout=wait)
        except KeyError:
            info = {}
        state = info.get("state")
        if state == "ALIVE":
            return
        if state == "DEAD":
            raise local_tasks.WorkerCrashedError(
                actor_id, f"{dag.dag_id}: the actor died again while restarting: "
                          f"{info.get('death_cause')}")
        if time.monotonic() > deadline:
            raise local_tasks.WorkerCrashedError(
                actor_id, f"{dag.dag_id}: not ALIVE within {RECOVERY_TIMEOUT_S}s of its "
                          f"restart (state={state!r})")


def _quiesce(dag) -> None:
    """Stops every surviving stage loop, closes the old group and sweeps
    every old-epoch shm slot. Best-effort: the dead cannot answer."""
    dag._teardown_actors(timeout=10.0)
    dag._destroy_group()


def _restore_snapshots(dag) -> None:
    for aid, blob in (dag._snapshots or {}).items():
        resp = dag._call_actor(aid, "dag_restore", {"dag_id": dag.dag_id, "blob": blob},
                               timeout=60)
        if (resp or {}).get("status") != "ok":
            raise RuntimeError(f"{dag.dag_id}: dag_restore failed on actor {aid}: {resp!r}")


def _replay(dag, start_seq: int) -> None:
    """Pushes every retained input from the replay base again, in order.
    When a replayed seq would outrun the slowest reader by a whole ring,
    that reader drains first (its frames are buffered or dropped here)."""
    for seq in sorted(s for s in dag._retained if s >= start_seq):
        while dag._out_readers:
            laggard = min(dag._out_readers, key=lambda r: r._next)
            if seq - laggard._next < dag.CHANNEL_DEPTH:
                break
            laggard.drain_one(time.monotonic() + _REPLAY_DRAIN_TIMEOUT_S)
        dag._push_input(seq, dag._retained[seq])


def recover(dag, err) -> None:
    """Restarts the victims, re-opens every channel under a new epoch and
    replays the retained inputs. Raises (and the caller tears the graph
    down) if any step fails: a half-recovered graph is worse than a dead
    one."""
    t0 = time.monotonic()
    new_epoch = dag._epoch + 1
    victims = _find_victims(dag, err)
    with flight.site("dag"):
        # Fixed-shape flight records: the new epoch rides the seq field,
        # the triggering edge the tag.
        flight.note(dag.dag_id, "dag_recovery_start",
                    tag=getattr(err, "channel", None) or "", seq=new_epoch)
    for aid in victims:
        _restart_victim(dag, aid)
    _quiesce(dag)
    dag._epoch = new_epoch
    plan = placement.PlacementPlan.resolve(dag._actor_ids)
    for aid in dag._actor_ids:
        if plan.rank_of(aid) != dag._plan.rank_of(aid):
            raise RuntimeError(f"{dag.dag_id}: rank drift on recovery for actor {aid} "
                               f"({dag._plan.rank_of(aid)} -> {plan.rank_of(aid)})")
    dag._plan = plan
    dag._lower(plan)
    _restore_snapshots(dag)
    if dag._retained:
        start_seq = min(dag._retained)
    elif dag._snapshot_base is not None:
        start_seq = dag._snapshot_base
    else:
        start_seq = dag._submitted
    dag._register(plan, need_group="device" in dag._families, epoch=new_epoch,
                  start_seq=start_seq)
    dag._open_driver_channels(plan, start_seq)
    _replay(dag, start_seq)
    dag._stall_event.clear()
    dag.last_recovery = {
        "victims": victims,
        "victim_ranks": sorted(plan.rank_of(a) for a in victims),
        "epoch": new_epoch,
        "start_seq": start_seq,
        "duration_s": time.monotonic() - t0,
    }
    with flight.site("dag"):
        flight.note(dag.dag_id, "dag_recovery_done",
                    tag=getattr(err, "channel", None) or "", seq=new_epoch)
