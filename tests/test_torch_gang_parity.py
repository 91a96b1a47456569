"""The port's gangs, placement groups, Tune trials and trainer on its runtime
against the JAX package's on its own, through one scripted scenario
(``tests/_torch_gang_scenario.py``) that each package runs in a subprocess
of its own with ``JAX_PLATFORMS=cpu``, at once.

The two records of outcomes must be equal: the placement group's listing,
removal and an infeasible group's timeout; the ``ring`` gang's ``run``,
``run_async``, ``rank_infos``, ``healthy``, a member's exception and a
member killed with ``kill``; the trial statuses and iterations of an ASHA
grid; and the steps, world sizes and restarts of a trainer fit whose rank 1
dies once.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _scenario(package: str) -> dict:
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_gang_scenario.py"), package],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_scripted_scenario_has_the_references_outcomes():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        reference, port = pool.map(_scenario, ["ray_tpu", "ray_tpu_torch"])
    assert port == reference
    # And the outcomes are the ones the API promises.
    assert reference["pg_listed"] == [["CREATED", [{"CPU": 1.0},
                                                   {"CPU": 1.0, "trainslot": 1.0}]]]
    assert reference["pg_removed"] == ["REMOVED"]
    assert reference["pg_infeasible"] == "PlacementGroupUnschedulableError"
    assert [r["sum"] for r in reference["gang_run"]] == [3.0, 3.0]
    assert [(r["x"], r["y"]) for r in reference["gang_run"]] == [(10, 5), (11, 5)]
    assert reference["gang_ranks"] == [0, 1] and reference["gang_pids_distinct"]
    assert reference["gang_raise"] is True and reference["gang_healthy_after_raise"]
    assert reference["gang_killed"] == "GangDiedError"
    assert not reference["gang_healthy_after_kill"]
    # ASHA (grace 1, max_t 4, rf 2) on scores x * step, one trial at a time.
    assert [t[1] for t in reference["tune"]] == ["TERMINATED"] * 3
    assert {t[0]: t[2] for t in reference["tune"]}[1.0] == 4
    assert reference["trainer_error"] and reference["trainer_steps"] == [0, 1, 2, 3]
    assert reference["trainer_last"] == [3, 2]
    assert reference["trainer_resizes"] == [["gang_died", 2]]
    assert reference["groups_left"] == []
