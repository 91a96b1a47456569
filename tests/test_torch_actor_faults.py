"""Two faults of the port's local actors (``_private/local_tasks.py``),
held to the reference's actor table.

* A wait for readiness never returns RESTARTING: the reference's
  ``rpc_get_actor_info`` waits on ``ready_event``, which a restart clears
  (``ray_tpu/_private/controller.py:1284, 1318-1326``), so the port's
  ``actor_info(wait_ready=True)`` right after a kill that restarts gives the
  new process, ALIVE.
* A restart whose new process dies before its constructor answers is one
  more death, as the reference's ``_handle_actor_failure`` counts it
  (``controller.py:1276-1295``): restarts go on while ``max_restarts``
  allows, then the actor is DEAD with a cause and its lease goes back to
  the host's ledger.

The reference's side needs a cluster, so it is cited, not run.
"""

import pytest

import _torch_dag_apps as apps
from ray_tpu_torch._private import local_tasks, resources

Stage = local_tasks.remote(apps.Stage)
ExitOnMarker = local_tasks.remote(apps.ExitOnMarker)


@pytest.fixture(scope="module", autouse=True)
def port_runtime():
    yield
    local_tasks.shutdown()


def test_wait_ready_after_a_restarting_kill_gives_the_new_process():
    a = Stage.options(max_restarts=5).remote(3)
    first = local_tasks.actor_info(a._actor_id, wait_ready=True, timeout=120)
    assert first["state"] == "ALIVE"
    pids = [first["pid"]]
    for n in range(1, 4):
        local_tasks.kill(a, no_restart=False)
        info = local_tasks.actor_info(a._actor_id, wait_ready=True, timeout=120)
        assert info["state"] == "ALIVE", info
        assert info["restarts"] == n and info["pid"] not in pids, (info, pids)
        pids.append(info["pid"])
        assert local_tasks.get(a.add.remote(1), timeout=60) == 4
    local_tasks.kill(a)


def test_restarts_that_die_in_the_constructor_end_dead_with_the_lease_back(tmp_path):
    marker = tmp_path / "marker"
    before = resources.available_resources()["CPU"]
    a = ExitOnMarker.options(max_restarts=3, num_cpus=1).remote(str(marker))
    assert local_tasks.actor_info(a._actor_id, wait_ready=True, timeout=120)["state"] == "ALIVE"
    assert resources.available_resources()["CPU"] == before - 1
    marker.write_text("die")
    # One death by the kill, then three restarts that each die before
    # their constructor answers.
    local_tasks.kill(a, no_restart=False)
    info = local_tasks.actor_info(a._actor_id, wait_ready=True, timeout=120)
    assert info["state"] == "DEAD" and info["restarts"] == 3, info
    assert "ended while restarting" in info["death_cause"], info
    assert resources.available_resources()["CPU"] == before
    with pytest.raises(local_tasks.WorkerCrashedError):
        local_tasks.get(a.pid.remote(), timeout=60)
