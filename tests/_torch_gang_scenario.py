"""One scripted scenario of gangs, trials and the trainer, for either package.

``python tests/_torch_gang_scenario.py ray_tpu`` (or ``ray_tpu_torch``)
starts a cluster of that package with ``init(num_cpus=4, resources=
{"trainslot": 2})`` (and short redials of a dead actor), then:

* creates a placement group, waits until it is ready, lists it, removes
  it, and has one the cluster can never hold raise after its timeout;
* runs a two-member ``ring`` gang on the CPU: ``run``, ``run_async``,
  ``rank_infos``, ``healthy``, a member's exception, and a member killed
  with the package's ``kill``, after which ``run`` raises
  ``GangDiedError``;
* runs a grid of a function trainable under ASHA through the package's
  ``TuneController``, one trial at a time: each trial's status and
  iterations are ASHA's decisions;
* fits a trainer whose rank 1 dies once, at step 2, and resumes from the
  last committed checkpoint;

and prints one JSON record of the outcomes on its last line. The functions
live at the top level here: the port's actors import this module by name
(its directory is the import root they add), the reference's receive them
by value.
"""

import importlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = (sys.argv[1] if __name__ == "__main__" and len(sys.argv) > 1
           else "ray_tpu_torch")
rt = importlib.import_module(PACKAGE)
pgs = importlib.import_module(f"{PACKAGE}.util.placement_group")
gang_mod = importlib.import_module(f"{PACKAGE}.util.gang")

# Redials of a dead actor's address end in about a second (both packages
# read the same knobs).
FAST = {"rpc_retry_max_backoff_s": 0.05, "rpc_retry_max_attempts": 6}
ASHA = {"grace_period": 1, "max_t": 4, "reduction_factor": 2}
GRID = [1.0, 4.0, 2.0]
STEPS, DIE_AT = 4, 2


def ident(ctx, x=0, *, y=0):
    total = ctx.collective().allreduce(np.array([ctx.rank + 1.0]))
    return {"rank": ctx.rank, "world": ctx.world_size, "x": x, "y": y,
            "sum": float(np.asarray(total)[0])}


def rank_of(ctx):
    return ctx.rank


def boom(ctx):
    raise KeyError(f"rank {ctx.rank}")


def climb(config):
    tune = importlib.import_module(f"{PACKAGE}.tune")
    for step in range(1, ASHA["max_t"] + 1):
        tune.report({"score": config["x"] * step})


def death_loop(config):
    """Rank 0 checkpoints {"step"} each step; rank 1 exits at ``DIE_AT``
    once in the run (its marker file says it did)."""
    train = importlib.import_module(f"{PACKAGE}.train")
    ckpts = importlib.import_module(f"{PACKAGE}.train.checkpoint")
    ctx = train.get_context()
    start, resumed = 0, train.get_checkpoint()
    if resumed is not None:
        state, _ = ckpts.load_pytree_checkpoint(resumed)
        start = int(state["step"]) + 1
    for step in range(start, STEPS):
        marker = os.path.join(config["dir"], "died")
        if step == DIE_AT and ctx.get_world_rank() == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        checkpoint = None
        if ctx.get_world_rank() == 0:
            checkpoint = ckpts.save_pytree_checkpoint({"step": np.array(step)})
        train.report({"step": step, "world_size": ctx.get_world_size()}, checkpoint=checkpoint)


def _error_name(fn) -> str:
    try:
        fn()
    except Exception as exc:  # the class is the outcome recorded
        return type(exc).__name__
    return "none"


def _gang_kwargs() -> dict:
    return {"backend": "ring"} if PACKAGE == "ray_tpu" else {"backend": "ring",
                                                             "use_gpu": False}


def placement(out: dict) -> None:
    pg = pgs.placement_group([{"CPU": 1}, {"CPU": 1, "trainslot": 1}], strategy="PACK")
    pg.ready(timeout=60)
    listed = [p for p in pgs.placement_group_table() if p["pg_id"] == pg.id]
    out["pg_listed"] = [[p["state"], p["bundles"]] for p in listed]
    pgs.remove_placement_group(pg)
    out["pg_removed"] = [p["state"] for p in pgs.placement_group_table() if p["pg_id"] == pg.id]
    never = pgs.placement_group([{"trainslot": 3}])
    out["pg_infeasible"] = _error_name(lambda: never.ready(timeout=1.0))
    pgs.remove_placement_group(never)


def gang(out: dict) -> None:
    g = gang_mod.WorkerGang(2, **_gang_kwargs())
    try:
        out["gang_run"] = g.run(ident, per_rank_args=[(10,), (11,)], y=5)
        out["gang_run_async"] = rt.get(g.run_async(ident), timeout=60)
        infos = g.rank_infos()
        out["gang_ranks"] = [i["rank"] for i in infos]
        out["gang_pids_distinct"] = len({i["pid"] for i in infos}) == 2
        out["gang_healthy"] = g.healthy()
        try:
            g.run(boom)
            out["gang_raise"] = "none"
        except Exception as exc:  # the class differs by package; the message is recorded
            out["gang_raise"] = "KeyError" in str(exc)
        out["gang_healthy_after_raise"] = g.healthy()
        rt.kill(g.members[1])
        out["gang_killed"] = _error_name(lambda: g.run(rank_of, timeout=60))
        out["gang_healthy_after_kill"] = g.healthy()
    finally:
        g.shutdown()


def tune_grid(out: dict, storage: str) -> None:
    """The grid through each package's ``TuneController``, one trial at a
    time, so that ASHA sees the same results in the same order."""
    trainable = importlib.import_module(f"{PACKAGE}.tune.trainable")
    schedulers = importlib.import_module(f"{PACKAGE}.tune.schedulers")
    basic = importlib.import_module(f"{PACKAGE}.tune.search.basic_variant")
    tc = importlib.import_module(f"{PACKAGE}.tune.execution.tune_controller")
    tune = importlib.import_module(f"{PACKAGE}.tune")
    controller = tc.TuneController(
        trainable.wrap_function(climb),
        searcher=basic.BasicVariantGenerator({"x": tune.grid_search(GRID)}),
        scheduler=schedulers.ASHAScheduler(metric="score", mode="max", **ASHA),
        metric="score", mode="max", max_concurrent_trials=1,
        experiment_dir=os.path.join(storage, "asha"))
    controller.searcher.set_search_properties(None, None, {})
    out["tune"] = [[t.config["x"], t.status, t.iteration] for t in controller.run()]


def trainer(out: dict, storage: str) -> None:
    train = importlib.import_module(f"{PACKAGE}.train")
    cls = train.JaxTrainer if PACKAGE == "ray_tpu" else train.TorchTrainer
    scaling = (train.ScalingConfig(num_workers=2) if PACKAGE == "ray_tpu"
               else train.ScalingConfig(num_workers=2, use_gpu=False))
    result = cls(death_loop, train_loop_config={"dir": storage}, scaling_config=scaling,
                 run_config=train.RunConfig(name="death", storage_path=storage,
                                            failure_config=train.FailureConfig(max_failures=1))
                 ).fit()
    # Which steps a restart replays depends on which checkpoint had
    # committed when rank 1 died (the reference's loop runs a report ahead
    # of its trainer, the port's waits for its ack): the record holds what
    # both guarantee.
    out["trainer_error"] = result.error is None
    out["trainer_steps"] = sorted({m["step"] for m in result.metrics_history})
    out["trainer_last"] = [result.metrics["step"], result.metrics["world_size"]]
    out["trainer_worlds"] = sorted({m["world_size"] for m in result.metrics_history})
    out["trainer_resizes"] = [[r["reason"], r["from"]] for r in result.resizes]


def main() -> dict:
    out: dict = {}
    storage = tempfile.mkdtemp(prefix="gang-scenario-")
    rt.init(num_cpus=4, resources={"trainslot": 2}, _system_config=FAST)
    try:
        placement(out)
        gang(out)
        tune_grid(out, storage)
        trainer(out, storage)
        out["groups_left"] = [p["state"] for p in pgs.placement_group_table()
                              if p["state"] != "REMOVED"]
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return out


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
