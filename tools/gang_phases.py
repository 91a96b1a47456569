"""Runs chip_smoke.py's gang, trainer and Tune phases alone, as its main()
runs them: 14 (the trainer, a death and its restart), 24 (Tune), 25
(config 1, the elastic step-down, the churn), 26 (the data plane and
config 1 fed by it) and 29 (the ring).

On a host with one CUDA card, from the root of a checkout:

    python3 tools/gang_phases.py [label]

It builds the card's kernels, then runs each phase with every launch count
set to 0 before it, held to the checks main() holds it to. To compare two
trees in one call, copy this file into the other tree's root as well and
run it there (``python3 gang_phases.py parent``): it imports the
``chip_smoke.py`` beside it (or one directory up). The last line is one
JSON object: ``label``, the build's seconds, and for each phase its wall,
the launches of this process, and the numbers that phase's restart,
formation and churn are read from (or the error that stopped it); then
what ``chip_smoke.on_runtime`` found after each cluster, where the tree
has it.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE if os.path.exists(os.path.join(HERE, "chip_smoke.py"))
                else os.path.dirname(HERE))

import chip_smoke as c  # noqa: E402


def main() -> None:
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "tree"}
    c.DEVICE_SMI = c.phase_device()
    t0 = time.perf_counter()
    c.phase_build()
    out["build_s"] = time.perf_counter() - t0

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            result, counts, _ = c._run_path(fn, *args)
        except BaseException:
            out[name] = {"wall_s": time.perf_counter() - t0,
                         "error": traceback.format_exc()[-3000:]}
            return None
        out[name] = {"wall_s": time.perf_counter() - t0,
                     "driver_launches": sum(counts.values())}
        return result

    trainer = run("trainer", c.phase_trainer, 0.0)
    if trainer:
        out["trainer"].update({k: trainer.get(k) for k in (
            "restart_s", "death_to_report_s", "death_to_notice_s", "restart_split_s",
            "restore_s", "gang_form_s", "timeline", "counts", "bitwise")})
    tuned = run("tune", c.phase_tune, 1.0)
    if tuned:
        b = tuned["trainers"]
        out["tune"].update(
            a_wall_s=tuned["config3"]["wall_s"], b_wall_s=b["wall_s"], at_once=b.get("at_once"),
            left=b.get("processes_left"), first_report_s=[t["first_report_s"] for t in b["trials"]],
            img_per_s=[t["img_per_s"] for t in b["trials"]],
            a_first_result_s=[t["first_result_s"] for t in tuned["config3"]["trials"]])
    elastic = run("elastic", c.phase_elastic)
    if elastic:
        down, churn = elastic["step_down"], elastic["churn"]
        out["elastic"].update(
            restart_s=down["restart_s"], death_to_report_s=down.get("death_to_report_s"),
            step_down_wait_s=down["step_down_wait_s"], formation_s=down["formation_s"],
            counts=down["counts"], b_timeline=down["timeline"],
            config1_gang_form_s=elastic["config1"]["gang_form_s"],
            config1_img_per_s=elastic["config1"]["img_per_s"],
            card_img_per_s=elastic["config1"]["card_img_per_s"],
            churn={k: churn[k] for k in ("wall_ratio", "grew_back", "final_world_size",
                                         "wall_churn_s", "wall_undisturbed_s",
                                         "churn_timeline", "base_timeline")})
    data = run("data", c.phase_data, elastic["config1"]["card_img_per_s"] if elastic else 1.0)
    if data:
        out["data"].update(img_per_s=data["config1"]["img_per_s"],
                           ingest_share=data["config1"]["ingest_share"])
    ring = run("ring", c.phase_ring)
    if ring:
        out["ring"].update(counts=ring["counts"],
                           exact_step_ms=ring["runs"]["exact"].get("step_ms"))
    out["settled"] = getattr(c, "SETTLED", None)
    print(json.dumps(out, default=str), flush=True)


# The data plane's workers are spawned processes, which import the main
# module again.
if __name__ == "__main__":
    main()
