"""Runs chip_smoke.py's Tune phase (24) several times in one process, each
with the checks main() holds it to, and prints what its gone-watch saw.

On a host with one CUDA card, from the root of a checkout:

    python3 tools/tune_repeat.py [times]

Each run prints one line ``REP {...}``: its wall, (b)'s wall, the trials
whose gang member only the watch's last poll found gone, and for each
trainer trial its learning rate, its reports and ``stop_to_gone_s`` (or
the error that stopped the run). The last line is the list of them all.
"""

import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def main() -> None:
    c.DEVICE_SMI = c.phase_device()
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    out = []
    for i in range(reps):
        t0 = time.perf_counter()
        try:
            b = c.phase_tune(1.0)["trainers"]
            out.append({"rep": i, "wall_s": time.perf_counter() - t0, "b_wall_s": b["wall_s"],
                        "seen_at_close": b["gone_seen_at_close"],
                        "trials": [(t["lr"], len(t["iterations"]), t["stop_to_gone_s"])
                                   for t in b["trials"]]})
        except BaseException:
            out.append({"rep": i, "wall_s": time.perf_counter() - t0,
                        "error": traceback.format_exc()[-2500:]})
        print("REP", json.dumps(out[-1]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
