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
* A gang's lease goes back when it shuts down, and when its start fails.
"""

import os
import threading
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import resources
from ray_tpu_torch.util import gang as gang_mod


@pytest.fixture
def host():
    yield resources.declare
    resources.declare()


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


def test_a_gpu_gang_does_not_grow_onto_two_half_free_cards(host):
    """Two cards with half of each free sum to one card's worth, but a
    gang member leases a whole card: the grow-back probe stays False until
    a whole card is free (``can_place``, not the summed ``GPU``)."""
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
    trainer = TorchTrainer(lambda config: None, scaling_config=ScalingConfig(
        num_workers=2, min_workers=1, use_gpu=True, elastic_grow_probe_period_s=1e-6))
    gang = SimpleNamespace(num_workers=1)
    assert not trainer._want_grow(gang, {})
    first.release()
    assert ledger.can_place({"CPU": 1, "GPU": 1})
    assert trainer._want_grow(gang, {})
    assert ledger.available_resources()["GPU"] == pytest.approx(1.5)  # nothing taken


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
def test_a_failed_gang_start_gives_its_lease_back(host, monkeypatch, how):
    host(num_cpus=8, resources={"trainslot": 2})
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
    assert resources.available_resources() == {"CPU": 8.0, "GPU": 0.0, "trainslot": 2.0}


def test_a_gang_holds_its_lease_until_shutdown(host):
    host(num_cpus=8, resources={"trainslot": 2})
    gang = gang_mod.WorkerGang(2, use_gpu=False, resources_per_worker={"CPU": 1, "trainslot": 1})
    try:
        assert resources.available_resources()["trainslot"] == 0.0
        assert gang.cards == [None, None]
        with pytest.raises(resources.PlacementGroupUnschedulableError):
            gang_mod.WorkerGang(1, use_gpu=False, resources_per_worker={"trainslot": 1},
                                ready_timeout=0.1)
    finally:
        gang.shutdown()
    assert resources.available_resources()["trainslot"] == 2.0
