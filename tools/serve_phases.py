"""Runs chip_smoke.py's serve phases alone, as its main() runs them.

On a host with one CUDA card, from the root of the repo:

    python3 tools/serve_phases.py                  # phases 30, 23, 27 (a), 27 (b)
    python3 tools/serve_phases.py --phases 23      # phase 23 only
    python3 tools/serve_phases.py --start-trials 2 # when one replica starts

With ``--phases`` (the default: all four) the card's kernels are built
first, phase 30 beside the build as main() runs it, then each phase runs
with every launch count set to 0 before it and is held to the same checks
main() holds it to. The last line is ``SERVE_PHASES {json}``: each phase's
wall and its numbers, or the error that stopped the run.

With ``--start-trials N`` it instead times one BERT-base replica's start
N times, each on a cluster of its own: when ``init()``, ``serve.start``
and ``serve.run`` returned, when the runtime first showed each actor in
each state and its process's start, and the replica constructor's marks
(started, weights built, buckets warmed), in seconds from the trial's
start. The last line is ``SERVE_START {json}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402

PHASES = ("30", "23", "27a", "27b")


def _phase_30(out: dict) -> None:
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(c.phase_build)
        t0 = time.perf_counter()
        llm_run, counts, routes = c._run_path(c.phase_serve_llm)
        out["wall30"] = time.perf_counter() - t0
        build.result()
    out["p30"] = {k: llm_run.get(k) for k in (
        "lost", "decode_controller_rpcs", "probe_rpc_methods", "probe_window_iterations", "qps",
        "phase_seconds", "ready_s", "recover_s", "decode_leases", "decode_pools", "p99_ratio")}
    replica_launches = [v["launches"] for k in llm_run["replica_kernels"] for v in k.values()]
    c.require(not any(replica_launches), f"serve_llm: replica launches {replica_launches}")
    c._path("serve_llm", {k: 0 for k in counts}, counts, routes, "wgmma")


def _phase_23(out: dict) -> None:
    t0 = time.perf_counter()
    http, local, _ = c._run_path(c.phase_serve_http)
    out["wall23"] = time.perf_counter() - t0
    c.require(local == c._expected(c.BERT_CONFIG["n_layers"], kernel_forwards=1),
              f"serve_http: this process launched {local}")
    c._path("serve_http", c._expected(c.BERT_CONFIG["n_layers"], kernel_forwards=http["forwards"]),
            http["counts"], http["routes"], "mma_sync", forwards=http["forwards"],
            replicas=http["replicas_reached"])
    out["p23"] = {k: http.get(k) for k in (
        "qps", "p50_ms", "p99_ms", "failed", "max_answer_err", "replicas_reached",
        "replicas_reached_s", "first_replica_s", "sse_tokens", "proxy_cpu_us_per_request",
        "proxy_busy_share", "phase_seconds", "counts", "placements", "replica_start_s")}


def _phase_27a(out: dict) -> None:
    layers = c.BERT_CONFIG["n_layers"]
    t0 = time.perf_counter()
    mux, local, _ = c._run_path(c.phase_serve_mux)
    out["wall27a"] = time.perf_counter() - t0
    c.require(local == c._expected(layers, kernel_forwards=mux["direct_forwards"]),
              f"serve_mux: this process launched {local}")
    c._replica_paths("serve_mux", layers, {pid: (*mux["counts_by_pid"][pid], rep["forwards"])
                                           for pid, rep in mux["replicas"].items()})
    out["p27a"] = {k: mux.get(k) for k in (
        "qps", "max_answer_err", "ready_s", "phase_seconds", "hit_p99_ms", "miss_p99_ms")}


def _phase_27b(out: dict) -> None:
    layers = c.BERT_CONFIG["n_layers"]
    t0 = time.perf_counter()
    chaos, local, _ = c._run_path(c.phase_serve_chaos)
    out["wall27b"] = time.perf_counter() - t0
    c.require(local == c._expected(layers, kernel_forwards=1),
              f"serve_chaos: this process launched {local}")
    c._replica_paths("serve_chaos", layers, chaos["counts_by_pid"])
    out["p27b"] = {k: chaos.get(k) for k in (
        "lost", "replica_kills", "proxy_kills", "replicas_recovered", "proxy_restarted",
        "p99_ratio", "recover_s", "ready_s", "phase_seconds", "baseline_qps")}


def run_phases(phases: list[str]) -> dict:
    out: dict = {"phases": phases}
    t_all = time.perf_counter()
    try:
        c.DEVICE_SMI = c.phase_device()
        if "30" in phases:
            _phase_30(out)  # builds the kernels beside it
        else:
            c.phase_build()
        for name, fn in (("23", _phase_23), ("27a", _phase_27a), ("27b", _phase_27b)):
            if name in phases:
                fn(out)
        out["ok"] = True
    except BaseException:
        out["error"] = traceback.format_exc()
    out["total_s"] = time.perf_counter() - t_all
    return out


def time_replica_start(trials: int) -> dict:
    import psutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker

    c.DEVICE_SMI = c.phase_device()
    c.phase_build()
    out: dict = {"trials": []}
    for _ in range(trials):
        t0 = time.time()
        rt.init(num_cpus=8)
        t_init = time.time()
        serve.start(http_port=None)
        t_controller = time.time()
        seen: dict = {}
        stop = threading.Event()

        def watch():
            ctx = worker.get_global_context()
            while not stop.is_set():
                for actor in ctx.io.run(ctx.controller.call("list_actors", {})):
                    key = f"{actor['name']}|{actor['state']}"
                    if key not in seen:
                        seen[key] = time.time() - t0
                        pid = actor.get("pid")
                        if pid and f"{actor['name']}|proc_start" not in seen:
                            try:
                                started = psutil.Process(pid).create_time()
                            except psutil.NoSuchProcess:
                                continue
                            seen[f"{actor['name']}|proc_start"] = started - t0
                stop.wait(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t_run = time.time()
        handle = serve.run(c.BertEncoder.options(num_replicas=1, autoscaling_config=None).bind(
            c.BERT_CONFIG, c.SEED, "cuda"), name="bert", route_prefix="/bert")
        t_ready = time.time()
        marks = handle.device_window.remote(0.0).result(timeout=120)["init_marks"]
        stop.set()
        watcher.join(10)
        out["trials"].append({
            "init": t_init - t0, "controller": t_controller - t0, "run_at": t_run - t0,
            "ready": t_ready - t0, **{k: v - t0 for k, v in marks.items()},
            "seen": {k: round(v, 2) for k, v in seen.items()}})
        serve.shutdown()
        rt.shutdown()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"a comma-separated subset of {','.join(PHASES)}")
    parser.add_argument("--start-trials", type=int, default=0,
                        help="time this many replica starts instead of running phases")
    args = parser.parse_args()
    if args.start_trials:
        print("SERVE_START " + json.dumps(time_replica_start(args.start_trials)), flush=True)
        return
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    out = run_phases(phases)
    print("SERVE_PHASES " + json.dumps(out, default=str), flush=True)
    sys.exit(0 if out.get("ok") else 1)


if __name__ == "__main__":
    main()
