"""The host's resource ledger (``ray_tpu_torch._private.resources``): the
port's stand-in for one node's resource table in the reference runtime.

* Totals come from the host (the CPUs this process may run on, the cards
  torch sees), and a declaration overrides any of them or adds keys, as
  the reference's ``init(num_cpus=, resources=)`` does; the package
  exports ``cluster_resources`` and ``available_resources``.
* Card shares follow serve's rules: a share below one takes the busiest
  card that still fits, whole cards take free ones.
* A lease places every bundle or none; a request the host can never hold
  raises at once, one that does not fit now after its timeout; waiting
  requests are served in the order they were made.
* A gang's placement group (on a runtime cluster, ``ray_tpu_torch.init``)
  gives its bundles back to the node agent when the gang shuts down, and
  when its start fails; the ledger is left to the local task layer.
"""

import os
import threading
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch._private import resources
from ray_tpu_torch.util import gang as gang_mod

import _torch_runtime as runtime  # noqa: E402

# The gang tests' cluster; the ledger's tests run without one.
cluster = runtime.cluster_fixture(num_cpus=8, num_gpus=2, resources={"trainslot": 2})


@pytest.fixture
def host():
    yield resources.declare
    resources.declare()


def test_gangs_trainers_trials_and_runners_need_init(tmp_path):
    # First in the module: its cluster, once booted, stays up to the end.
    """Without ``ray_tpu_torch.init()`` nothing forms a gang, a trial or a
    runner outside the runtime: each raises the runtime's own error."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
    from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
    from ray_tpu_torch.train.config import RunConfig, ScalingConfig
    from ray_tpu_torch.train.trainer import TorchTrainer

    assert not ray_tpu_torch.is_initialized()
    uninitialized = "has not been initialized"
    with pytest.raises(RuntimeError, match=uninitialized):
        gang_mod.WorkerGang(1, use_gpu=False)
    with pytest.raises(RuntimeError, match=uninitialized):
        TorchTrainer(_no_loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
                     run_config=RunConfig(storage_path=str(tmp_path))).fit()
    with pytest.raises(RuntimeError, match=uninitialized):
        tune.Tuner(_no_loop, run_config=RunConfig(storage_path=str(tmp_path))).fit()
    with pytest.raises(RuntimeError, match=uninitialized):
        EnvRunnerGroup("CartPole-v1", RLModuleSpec(), num_env_runners=1)


def _no_loop(config):
    pass


def test_totals_come_from_the_host(host):
    ledger = host()
    totals = ledger.cluster_resources()
    assert totals == {"CPU": float(len(os.sched_getaffinity(0))),
                      "GPU": float(torch.cuda.device_count())}
    assert ray_tpu_torch.cluster_resources() == totals
    assert ray_tpu_torch.available_resources() == totals


def test_a_declaration_overrides_and_adds_keys(host):
    host(num_cpus=64, resources={"TPU": 8, "GPU": 2})
    assert ray_tpu_torch.cluster_resources() == {"CPU": 64.0, "GPU": 2.0, "TPU": 8.0}
    lease = resources.ledger().acquire({"CPU": 1, "TPU": 8})
    assert ray_tpu_torch.available_resources() == {"CPU": 63.0, "GPU": 2.0, "TPU": 0.0}
    lease.release()
    lease.release()  # a second release gives nothing back twice
    assert ray_tpu_torch.available_resources()["TPU"] == 8.0
    with pytest.raises(ValueError, match="whole cards"):
        resources.HostLedger(num_gpus=1.5)


def test_card_shares_follow_serves_rules():
    ledger = resources.HostLedger(num_cpus=4, num_gpus=2)
    halves = [ledger.acquire({"GPU": 0.5}) for _ in range(2)]
    assert [h.cards for h in halves] == [[[0]], [[0]]]  # the busiest card that fits
    whole = ledger.acquire({"GPU": 1})
    assert whole.cards == [[1]] and whole.visible_devices() == "1"
    with pytest.raises(resources.PlacementGroupUnschedulableError):
        ledger.acquire({"GPU": 0.5})
    halves[0].release()
    assert ledger.acquire({"GPU": 0.25}).cards == [[0]]
    assert ledger.available_resources()["GPU"] == pytest.approx(0.25)
    with pytest.raises(ValueError, match="share of one card"):
        ledger.acquire({"GPU": 1.5})
    # Two whole cards for one bundle.
    two = resources.HostLedger(num_gpus=3).acquire({"GPU": 2})
    assert two.cards == [[0, 1]] and two.visible_devices() == "0,1"


class _Share:
    """An actor that holds the card share it leased."""

    def ping(self) -> str:
        return "ok"


def test_a_gpu_gang_does_not_grow_onto_two_half_free_cards(host, cluster):
    """Two cards with half of each free sum to one card's worth, but a
    whole-card bundle needs a whole card: the ledger does not place it
    (``can_place``, not the summed ``GPU``). The trainer's grow-back probe
    reads the runtime's free resources, as the reference's does: summed,
    so it stays False while less than a card's worth is free and turns True
    once a card's worth is (a whole card or not: ROADMAP 14c)."""
    from types import SimpleNamespace

    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import TorchTrainer

    ledger = host(num_cpus=8, num_gpus=2)
    first = ledger.acquire({"GPU": 0.5})
    spacer = ledger.acquire({"GPU": 0.5})  # fills card 0, so the next half goes to card 1
    second = ledger.acquire({"GPU": 0.5})
    spacer.release()
    assert (first.cards, second.cards) == ([[0]], [[1]])
    assert ledger.available_resources()["GPU"] == pytest.approx(1.0)
    assert not ledger.can_place({"CPU": 1, "GPU": 1})
    assert ledger.can_place({"CPU": 1, "GPU": 0.5}, 2)
    assert not ledger.can_place({"CPU": 1, "GPU": 0.5}, 3)
    first.release()
    assert ledger.can_place({"CPU": 1, "GPU": 1})
    trainer = TorchTrainer(lambda config: None, scaling_config=ScalingConfig(
        num_workers=2, min_workers=1, use_gpu=True, elastic_grow_probe_period_s=1e-6))
    gang = SimpleNamespace(num_workers=1)
    share = ray_tpu_torch.remote(_Share)
    held = [share.options(num_cpus=0, num_gpus=0.5).remote() for _ in range(3)]
    try:
        ray_tpu_torch.get([h.ping.remote() for h in held], timeout=60)
        assert ray_tpu_torch.available_resources()["GPU"] == pytest.approx(0.5)
        assert not trainer._want_grow(gang, {})
        ray_tpu_torch.kill(held.pop())
        deadline = time.monotonic() + 10
        while not trainer._want_grow(gang, {}) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ray_tpu_torch.available_resources()["GPU"] == pytest.approx(1.0)
        assert trainer._want_grow(gang, {})
    finally:
        for h in held:
            ray_tpu_torch.kill(h)


def test_a_request_the_host_cannot_hold_raises_at_once():
    ledger = resources.HostLedger(num_cpus=2, num_gpus=1, resources={"trainslot": 4})
    start = time.monotonic()
    with pytest.raises(resources.InfeasibleResourcesError, match="asks for 3 CPUs"):
        ledger.acquire({"CPU": 1}, 3, timeout=30)
    with pytest.raises(ValueError, match="asks for 2 GPUs, this host has 1"):
        ledger.acquire({"CPU": 1, "GPU": 1}, 2, timeout=30)
    with pytest.raises(resources.InfeasibleResourcesError, match="TPUs"):
        ledger.acquire({"TPU": 1}, timeout=30)
    with pytest.raises(resources.InfeasibleResourcesError, match="does not fit"):
        resources.HostLedger(num_gpus=2).acquire({"GPU": 0.6}, 3, timeout=30)
    assert time.monotonic() - start < 5


def test_a_busy_request_waits_its_timeout_then_raises():
    ledger = resources.HostLedger(num_cpus=4, resources={"trainslot": 4})
    held = ledger.acquire({"trainslot": 1}, 2)
    assert held.cards == [[], []]
    start = time.monotonic()
    with pytest.raises(resources.PlacementGroupUnschedulableError, match="within 0.3 s"):
        ledger.acquire({"CPU": 1, "trainslot": 1}, 3, timeout=0.3)
    assert 0.3 <= time.monotonic() - start < 5
    assert ledger.available_resources() == {"CPU": 4.0, "trainslot": 2.0, "GPU": 0.0}
    got = []
    waiter = threading.Thread(target=lambda: got.append(
        ledger.acquire({"trainslot": 1}, 3, timeout=30)))
    waiter.start()
    time.sleep(0.2)
    assert not got
    held.release()
    waiter.join(10)
    assert got and ledger.available_resources()["trainslot"] == 1.0


def test_waiting_requests_are_served_in_order():
    """A request made while another waits queues behind it, even when it
    alone would fit: the first in line takes what frees first."""
    ledger = resources.HostLedger(num_cpus=4, resources={"slot": 2})
    held = ledger.acquire({"slot": 2})
    order, leases = [], {}

    def wait_for(n, name):
        leases[name] = ledger.acquire({"slot": n}, timeout=30)
        order.append(name)

    first = threading.Thread(target=wait_for, args=(2, "two"))
    first.start()
    time.sleep(0.1)
    second = threading.Thread(target=wait_for, args=(1, "one"))
    second.start()
    time.sleep(0.1)
    with pytest.raises(resources.PlacementGroupUnschedulableError):
        ledger.acquire({"CPU": 1})  # a try behind the line fails at once
    held.release()
    first.join(10)
    assert order == ["two"]
    second.join(0.3)
    assert second.is_alive()  # still waiting for a slot the first holds
    leases["two"].release()
    second.join(10)
    assert order == ["two", "one"]


@pytest.mark.parametrize("how", ["no_port", "start_timeout"])
def test_a_failed_gang_start_gives_its_lease_back(cluster, monkeypatch, how):
    free = ray_tpu_torch.available_resources()
    if how == "no_port":
        def no_port():
            raise OSError("no free port")

        monkeypatch.setattr(gang_mod, "_free_port", no_port)
        with pytest.raises(OSError, match="no free port"):
            gang_mod.WorkerGang(2, use_gpu=False, resources_per_worker={"CPU": 1, "trainslot": 1})
    else:
        monkeypatch.setattr(gang_mod, "START_TIMEOUT_S", 0.0)
        with pytest.raises(gang_mod.GangDiedError, match="failed to start"):
            gang_mod.WorkerGang(2, use_gpu=False, resources_per_worker={"CPU": 1, "trainslot": 1})
    assert runtime.settled(free) and free["trainslot"] == 2.0


def test_a_gang_holds_its_lease_until_shutdown(cluster):
    free = ray_tpu_torch.available_resources()
    gang = gang_mod.WorkerGang(2, use_gpu=False, resources_per_worker={"CPU": 1, "trainslot": 1})
    try:
        assert ray_tpu_torch.available_resources()["trainslot"] == 0.0
        # A member with no GPU lease sees no card.
        assert [i["cuda_visible_devices"] for i in gang.rank_infos()] == ["", ""]
        with pytest.raises(exceptions.PlacementGroupUnschedulableError):
            gang_mod.WorkerGang(1, use_gpu=False, resources_per_worker={"trainslot": 1},
                                ready_timeout=0.1)
    finally:
        gang.shutdown()
    assert runtime.settled(free) and ray_tpu_torch.available_resources()["trainslot"] == 2.0

