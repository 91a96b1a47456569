"""The port's comm flight recorder (``ray_tpu_torch.util.collective.
flight``) and hang report (``ray_tpu_torch._private.hang_doctor``) against
the reference's (``ray_tpu/util/collective/flight.py``,
``ray_tpu/_private/hang_doctor.py``, ``tests/test_hang_doctor.py``).

The recorder runs the same scripts in both packages under an injected
clock (no watchdog thread, no sleeps): the ring, the records, the
per-channel deadlines, ``check_once`` and its cooldown give the same
answers. ``build_report`` and ``blamed_ranks`` give the same report on the
same evidence. End to end, a 2-rank CPU ring gang in which rank 1 sleeps
several times past the channel deadline before an allreduce: rank 0's
watchdog fires, each member answers the ``comm_flight`` query on its
listener, and the report blames rank 1 alone; the same gang under uniform
delays records no stall. The delay is explicit, not a chaos schedule.
"""

import time

import pytest

from ray_tpu._private import hang_doctor as ref_doctor
from ray_tpu.util.collective import flight as ref_flight
from ray_tpu_torch._private import hang_doctor
from ray_tpu_torch.util.collective import comm_flight
from ray_tpu_torch.util.collective import flight
from ray_tpu_torch.util.gang import WorkerGang

import _torch_runtime as runtime  # noqa: E402

# The gangs, trials and RLlib actors here run on one cluster a module.
cluster = runtime.cluster_fixture(autouse=True, num_cpus=8)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _recorder(mod, capacity=16, publish=None, **tuning):
    clock = FakeClock()
    rec = mod.FlightRecorder(capacity=capacity, clock=clock,
                             publish=publish if publish is not None else (lambda e: None),
                             start_watchdog=False)
    for key, value in tuning.items():
        setattr(rec, key, value)
    return rec, clock


def _plain(records):
    """Dicts without the wall-clock stamp, which differs run to run."""
    return [{k: v for k, v in r.items() if k != "t_wall"} for r in records]


def _lifecycle(mod):
    rec, clock = _recorder(mod)
    out = []
    r = rec.start("train", "recv", "act.s1", rank=0, world_size=2, peer=1)
    out.append((r.state, r.seq))
    rec.launched(r)
    clock.advance(1.5)
    out += [rec.inflight_summary(), _plain(rec.snapshot())]
    rec.completed(r)
    bad = rec.start("train", "recv", "act.s2", rank=0, world_size=2, peer=1)
    rec.completed(bad, ok=False)
    for i in range(20):  # past the ring's capacity
        rec.note("g", "allreduce", "__ar", rank=0, world_size=2, nbytes=i)
    seqs = [rec.start("g1", "send", f"mb{i}").seq for i in (3, 7)]
    seqs.append(rec.start("g1", "send", "mb9", seq=41).seq)
    with mod.site("pipeline"), mod.trace("deadbeef"):
        labelled = rec.start("train", "send", "act.s0", peer=1).to_dict()
    out += [_plain(rec.snapshot(8)), rec.inflight_summary(), seqs,
            {k: labelled[k] for k in ("site", "trace_id", "channel")},
            len(rec._chan_stats["train:recv:act.s{}"])]
    return out


def _deadlines(mod):
    rec, clock = _recorder(mod, min_deadline_s=1.0, k=2.0, min_samples=4,
                           startup_deadline_s=10.0)
    out = [rec.deadline_s("g:allreduce:__ar")]
    for dt in (2.0, 2.0, 2.5, 2.0, 0.01, 0.01, 0.01, 0.01, 9.0):
        r = rec.start("g", "allreduce", "__ar")
        clock.advance(dt)
        rec.completed(r)
        out.append(rec.deadline_s("g:allreduce:__ar"))
    return out


def _watchdog(mod):
    events = []
    rec, clock = _recorder(mod, publish=events.append, min_deadline_s=0.5,
                           startup_deadline_s=1.0, cooldown_s=5.0)
    heard = []
    mod.register_stall_listener("g", heard.append)
    try:
        out = []
        r1 = rec.start("g", "recv", "act.s0", rank=0, world_size=2, peer=1)
        clock.advance(0.5)
        out.append(rec.check_once())
        clock.advance(1.5)
        out.append(_plain(rec.check_once()))
        out.append(r1.stalled)
        r2 = rec.start("g", "recv", "act.s0", rank=0, world_size=2, peer=1)
        clock.advance(2.0)
        out += [rec.check_once(), r2.stalled]
        r3 = rec.start("g", "recv", "act.s0", rank=0, world_size=2, peer=1)
        clock.advance(4.0)
        out += [_plain(rec.check_once()), r3.stalled, rec.stall_count(),
                _plain(rec.stall_events()), _plain(events)]
        # Only listeners whose prefix the stalled group starts with hear it
        # (the recorder's check_once calls the module's listeners).
        out.append(len(heard))
    finally:
        mod.unregister_stall_listener(heard.append)
    return out


@pytest.mark.parametrize("script", [_lifecycle, _deadlines, _watchdog],
                         ids=["lifecycle", "deadlines", "watchdog"])
def test_recorder_answers_as_the_reference(script):
    assert script(flight) == script(ref_flight)


def test_channel_skeleton_and_knobs_are_the_reference(monkeypatch):
    for tag in ("s3.f2v11", "__barrier7/r0", "", "__gb12:ab3f/rs", "dagch:p0:e1:2:0"):
        assert flight.channel_skeleton(tag) == ref_flight.channel_skeleton(tag)
    assert flight.channel_id("train", "recv", "act.s4") == "train:recv:act.s{}"
    for name, value in (("RAY_TPU_COMM_WATCHDOG_MIN_S", "0.7"),
                        ("RAY_TPU_COMM_WATCHDOG_K", "3"),
                        ("RAY_TPU_COMM_WATCHDOG_STARTUP_S", "12"),
                        ("RAY_TPU_COMM_FLIGHT_CAPACITY", "64")):
        monkeypatch.setenv(name, value)
    port = flight.FlightRecorder(start_watchdog=False)
    ref = ref_flight.FlightRecorder(start_watchdog=False, publish=lambda e: None)
    for attr in ("capacity", "min_deadline_s", "k", "startup_deadline_s", "min_samples",
                 "tick_s", "cooldown_s"):
        assert getattr(port, attr) == getattr(ref, attr), attr


# ---------------------------------------------------------------------------
# the report on the same evidence
# ---------------------------------------------------------------------------

def _rec(rank, state, seq, *, peer=-1, age=None, worker=None,
         channel="train:recv:act.s{}", stalled=False, world=4):
    group, kind, skel = channel.split(":")
    out = {"group": group, "kind": kind, "tag": skel, "channel": channel, "seq": seq,
           "rank": rank, "world_size": world, "peer": peer, "state": state,
           "stalled": stalled, "_worker": worker or f"w{rank}", "_node": "node-a"}
    if age is not None:
        out["age_s"] = age
    return out


MERGE_CASES = {
    "frontier": [_rec(0, "launched", 7, peer=3, age=12.5), _rec(0, "completed", 6),
                 _rec(1, "completed", 7), _rec(2, "completed", 6)],
    "no_evidence": [_rec(0, "launched", 3, peer=2, age=30.0)],
    "all_waiting": [_rec(r, "launched", 5, peer=(r + 1) % 4, age=3.0 + r) for r in range(4)],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_channel_is_the_reference(case):
    records = MERGE_CASES[case]
    assert hang_doctor._merge_channel("train:recv:act.s{}", records) == \
        ref_doctor._merge_channel("train:recv:act.s{}", records)


def _evidence():
    return {
        "node-a": {"status": "ok", "workers": {
            "w0": {"status": "ok", "pid": 111, "records": [
                _rec(0, "launched", 7, peer=1, age=12.5),
                _rec(0, "launched", 2, peer=1, age=9.0, channel="train:send:rogue.q{}",
                     stalled=True)],
                "stacks": {"MainThread": "File ...recv..."}},
            "w1": {"status": "ok", "pid": 222, "records": [_rec(1, "completed", 6)],
                   "stacks": {"MainThread": "File ...sleep..."}},
            "w2": {"status": "error", "error": "worker gone"}}},
        "node-b": {"status": "error", "error": "agent unreachable"},
    }


@pytest.mark.parametrize("include_stacks", [True, False])
def test_build_report_and_blamed_ranks_are_the_reference(include_stacks):
    """With no static comm sites (the port has no comm-graph extractor, and
    the reference degrades the same way without one) no channel is
    drift, in either package."""
    stalls = [{"channel": "train:recv:act.s{}", "group": "train", "kind": "recv",
               "age_s": 12.5, "deadline_s": 2.0}]
    assert hang_doctor.static_comm_sites() == []
    port = hang_doctor.build_report(stalls, _evidence(), include_stacks=include_stacks)
    ref = ref_doctor.build_report(stalls, _evidence(), static_sites=[],
                                  include_stacks=include_stacks)
    port.pop("generated_at"), ref.pop("generated_at")
    assert port == ref
    assert hang_doctor.blamed_ranks(port) == ref_doctor.blamed_ranks(ref) == {1, 2, 3}
    assert all(c["in_static_graph"] is None and not c["protocol_drift"]
               for c in port["channels"])


# ---------------------------------------------------------------------------
# end to end: a 2-rank CPU ring gang with one slow rank
# ---------------------------------------------------------------------------

DEADLINE_S = 2.0    # the members' channel deadline floor and startup grace
SLOW_S = 8.0        # rank 1's delay: four deadlines


def _allreduces(ctx, times: int, delay: float = 0.0):
    import numpy as np

    out = []
    for _ in range(times):
        time.sleep(delay)
        out.append(float(ctx.collective().allreduce(np.ones(4), tag="hang")[0]))
    return out, flight.stall_count()


def _slow_rank_1(ctx, delay: float):
    import numpy as np

    if ctx.rank == 1:
        time.sleep(delay)
    return float(ctx.collective().allreduce(np.ones(4), tag="hang")[0])


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    knobs = {"RAY_TPU_COMM_WATCHDOG_MIN_S": str(DEADLINE_S),
             "RAY_TPU_COMM_WATCHDOG_STARTUP_S": str(DEADLINE_S),
             "RAY_TPU_COMM_WATCHDOG_TICK_S": "0.05"}
    # The members read them (their recorders start at their first op).
    gang = WorkerGang(2, use_gpu=False, backend="ring", env_vars=knobs)
    yield gang
    gang.shutdown()


def test_uniform_delays_raise_no_stall(ring):
    for sums, stalls in ring.run(_allreduces, timeout=120, times=4, delay=0.3):
        assert sums == [2.0] * 4 and stalls == 0


def test_one_slow_rank_is_named_by_the_hang_report(ring):
    addresses = {info["rank"]: tuple(info["ring_address"]) for info in ring.rank_infos()}
    before = comm_flight(addresses[0])["stalls"]
    refs = ring.run_async(_slow_rank_1, delay=SLOW_S)
    deadline = time.monotonic() + SLOW_S - 1.0
    while len(comm_flight(addresses[0])["stalls"]) == len(before):
        assert time.monotonic() < deadline, "rank 0's watchdog never fired"
        time.sleep(0.1)
    stalls, evidence = hang_doctor.harvest(addresses)
    workers = evidence["local"]["workers"]
    assert sorted(workers) == ["rank0", "rank1"]
    assert all(w["status"] == "ok" and w["pid"] for w in workers.values())
    report = hang_doctor.build_report(stalls, evidence)
    assert hang_doctor.blamed_ranks(report) == {1}
    waiting = {w["rank"] for c in report["channels"] for w in c["waiting_ranks"]}
    assert waiting == {0}
    assert any("suspect rank 1" in line for line in report["summary"])
    # The stall resolves once rank 1 arrives.
    assert ring.get(refs, timeout=60) == [2.0, 2.0]
