"""Core-runtime microbenchmarks.

Role-equivalent of python/ray/_private/ray_perf.py (`ray microbenchmark`,
SURVEY §4.5/§6): single-client sync tasks/s, 1:N async tasks/s, actor
calls/s, put/get throughput. Prints one line per benchmark; used by the
release-style perf suite to track core-runtime regressions.
"""

from __future__ import annotations

import time

import numpy as np


def _rate(n: int, seconds: float) -> str:
    return f"{n / seconds:,.0f}/s"


def main() -> dict:
    import ray_tpu_torch

    owns_cluster = not ray_tpu_torch.is_initialized()
    if owns_cluster:
        ray_tpu_torch.init(num_cpus=8)
    results: dict[str, float] = {}

    @ray_tpu_torch.remote
    def noop():
        return None

    @ray_tpu_torch.remote
    class Actor:
        def noop(self):
            return None

    # Warmup: spawn workers + ship code, then let the spawn burst settle —
    # the sync phase must not time worker-startup noise (the reference's
    # `ray microbenchmark` warms up each phase the same way).
    ray_tpu_torch.get([noop.remote() for _ in range(20)])
    time.sleep(1.0)
    for _ in range(20):
        ray_tpu_torch.get(noop.remote())

    n = 200
    start = time.perf_counter()
    for _ in range(n):
        ray_tpu_torch.get(noop.remote())
    dt = time.perf_counter() - start
    results["single_client_sync_tasks_per_s"] = n / dt
    print(f"single-client sync tasks: {_rate(n, dt)}")

    ray_tpu_torch.get([noop.remote() for _ in range(200)])  # phase warmup
    n = 1000
    start = time.perf_counter()
    ray_tpu_torch.get([noop.remote() for _ in range(n)])
    dt = time.perf_counter() - start
    results["async_tasks_per_s"] = n / dt
    print(f"1:N async tasks:          {_rate(n, dt)}")

    actor = Actor.remote()
    ray_tpu_torch.get([actor.noop.remote() for _ in range(50)])
    n = 500
    start = time.perf_counter()
    for _ in range(n):
        ray_tpu_torch.get(actor.noop.remote())
    dt = time.perf_counter() - start
    results["sync_actor_calls_per_s"] = n / dt
    print(f"sync actor calls:         {_rate(n, dt)}")

    n = 2000
    start = time.perf_counter()
    ray_tpu_torch.get([actor.noop.remote() for _ in range(n)])
    dt = time.perf_counter() - start
    results["async_actor_calls_per_s"] = n / dt
    print(f"async actor calls:        {_rate(n, dt)}")

    payload = np.zeros(8 * 1024 * 1024, dtype=np.uint8)  # 8 MiB
    n = 20
    start = time.perf_counter()
    refs = [ray_tpu_torch.put(payload) for _ in range(n)]
    dt = time.perf_counter() - start
    gib = n * payload.nbytes / dt / 1e9
    results["put_gbps"] = gib
    print(f"put throughput (8MiB):    {gib:.2f} GB/s")

    start = time.perf_counter()
    for ref in refs:
        ray_tpu_torch.get(ref)
    dt = time.perf_counter() - start
    gib = n * payload.nbytes / dt / 1e9
    results["get_gbps"] = gib
    print(f"get throughput (8MiB):    {gib:.2f} GB/s")

    if owns_cluster:
        ray_tpu_torch.shutdown()
    return results


if __name__ == "__main__":
    main()
