"""DatasetStats — per-operator execution stats.

Copy of ray_tpu's ``data/_internal/stats.py``: per-operator wall time,
task-side CPU time, task counts, output rows/bytes, plus consumption-side
iterator wait time, rendered as the table behind Dataset.stats(), so
"where did my ingest time go" has an answer (wall vs cpu separates
scheduling overhead from UDF cost; iterator wait separates producer-bound
from consumer-bound pipelines).
"""

from __future__ import annotations


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


class DatasetStats:
    def __init__(self):
        self.stages: list[dict] = []
        self.total_wall_s: float = 0.0
        # Consumption side (recorded by DataIterator): time the consumer
        # spent blocked waiting for the next block, vs time in user code.
        self.iter_wait_s: float = 0.0
        self.iter_user_s: float = 0.0
        self.iter_local_s: float = 0.0
        self.iter_batches: int = 0

    def record_stage(
        self,
        name: str,
        wall_s: float,
        blocks: int,
        rows: int,
        *,
        bytes_out: int = 0,
        cpu_s: float = 0.0,
        tasks: int = 0,
    ) -> None:
        self.stages.append(
            {
                "stage": name,
                "wall_s": wall_s,
                "blocks": blocks,
                "rows": rows,
                "bytes": bytes_out,
                "cpu_s": cpu_s,
                "tasks": tasks,
            }
        )
        self.total_wall_s += wall_s

    def record_iter(self, wait_s: float, user_s: float, batches: int,
                    local_s: float = 0.0) -> None:
        self.iter_wait_s += wait_s
        self.iter_user_s += user_s
        self.iter_local_s += local_s
        self.iter_batches += batches

    def replace_stages(self, stage_stats: list) -> None:
        """Install the per-operator records of ONE execution (streaming
        epochs re-execute the plan; stats reflect the latest run, while
        iterator counters keep accumulating)."""
        self.stages = []
        self.total_wall_s = 0.0
        for s in stage_stats:
            self.record_stage(
                s.name, s.wall_s, s.blocks_out, s.rows_out,
                bytes_out=s.bytes_out, cpu_s=s.cpu_s, tasks=s.tasks,
            )

    def summary_string(self) -> str:
        header = (
            f"  {'operator':<28} {'wall':>9} {'cpu':>9} {'tasks':>6} "
            f"{'blocks':>7} {'rows':>10} {'bytes':>10}"
        )
        lines = ["Dataset execution stats:", header]
        for s in self.stages:
            lines.append(
                f"  {s['stage']:<28} {s['wall_s'] * 1e3:>7.1f}ms "
                f"{s['cpu_s'] * 1e3:>7.1f}ms {s['tasks']:>6} "
                f"{s['blocks']:>7} {s['rows']:>10} "
                f"{_fmt_bytes(s['bytes']):>10}"
            )
        lines.append(f"  total wall: {self.total_wall_s * 1e3:.1f}ms")
        if self.iter_batches:
            lines.append(
                f"  iterator: {self.iter_batches} batches, "
                f"wait {self.iter_wait_s * 1e3:.1f}ms "
                f"(blocked on producers), "
                f"local {self.iter_local_s * 1e3:.1f}ms "
                f"(batching/format), "
                f"user {self.iter_user_s * 1e3:.1f}ms"
            )
        return "\n".join(lines)
