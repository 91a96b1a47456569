"""The flight recorder's math: the gang aggregator and goodput buckets.

Copy of ray_tpu's ``_private/workload.py`` (``StepStatsAggregator``,
``goodput_buckets`` and their helpers), which the trainer's
``FlightRecorder`` (``train/step_stats.py``) folds each report round into:
rolling tokens/s and MFU, the phase breakdown, the MAD straggler scan, and
the wall clock of an elastic run cut into productive, checkpoint, restart
and stalled time. Pure math, with the reference's chaos guard: a record
whose per-rank step is not newer than the last one seen is dropped, and
a negative phase is clamped to zero.

The peak table is the port's own: it is keyed by
``torch.cuda.get_device_name()`` where the reference keys TPU kinds.
Serve keeps its ``LatencyHistogram`` in ``serve/_common.py``.
"""

from __future__ import annotations

import collections
from typing import Any

# Per-rank phase fields of a StepStats record (seconds). ``wall_s`` is
# the full report-to-report interval; ``compute_s`` is derived as the
# remainder so the phases always sum to wall. ``pp_bubble_s`` is time a
# pipeline stage spent blocked on a neighbor's activations —
# zero on non-pipelined runs. ``comm_exposed_s`` is the slice
# of collective time the step actually BLOCKED on under overlapped
# gradient sync; when the overlap path ran, the compute remainder
# subtracts the exposed slice instead of ``collective_s`` (the total op
# time, which keeps accumulating on background threads), so wall is
# partitioned by what stole step time, not by where work happened.
STEP_PHASES = (
    "data_wait_s",
    "compute_s",
    "collective_s",
    "checkpoint_s",
    "pp_bubble_s",
    "comm_exposed_s",
)

# Sub-phase split of ``compute_s``: ranks running with step
# annotations report how compute divides into forward, backward, and
# optimizer time. These are *additive detail* under compute_s — they
# never enter the wall-partition identity above, and ranks that cannot
# split (fused GSPMD single-program path) simply omit them.
SUB_PHASES = (
    "fwd_s",
    "bwd_s",
    "opt_s",
)

# Peak dense bf16 FLOP/s per card, keyed by ``torch.cuda.get_device_name()``
# and matched by prefix: the H100 SXM's 989e12 is its data sheet's dense
# (no sparsity) bf16 tensor-core rate, as chip_smoke.py's bound takes it.
PEAK_FLOPS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops_per_chip(device_kind: str | None) -> float | None:
    """The card's peak from the table, matched by prefix. None for unknown
    kinds (CPU workers): MFU is then not reported rather than wrong."""
    if not device_kind:
        return None
    return next(
        (v for k, v in PEAK_FLOPS_BY_KIND.items() if device_kind.startswith(k)),
        None,
    )


def flops_for_tokens(params: int, tokens: float) -> float:
    """The fwd+bwd rule of thumb: 6 * params * tokens."""
    return 6.0 * float(params) * float(tokens)


def _num(value: Any, default: float = 0.0) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return default
    return float(value)


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class StepStatsAggregator:
    """Folds per-rank StepStats records into gang-level rolling stats.

    Lives on the train driver (one per fit()) and feeds both the
    controller workload series and the straggler detector. ``window``
    bounds every internal structure — a week-long run costs the same
    memory as a minute-long one.
    """

    def __init__(self, window: int = 64):
        self.window = max(4, int(window))
        # Chaos guard: last step index ingested per rank. Replayed or
        # duplicated rounds re-deliver old step indices and are dropped.
        self._last_step: dict[int, int] = {}
        # step -> {"walls": {rank: wall_s}, "ts": float, "tokens": float,
        #          "flops": float, phase sums...}; bounded to `window`.
        self._by_step: collections.OrderedDict[int, dict] = (
            collections.OrderedDict()
        )
        self._rank_node: dict[int, str] = {}
        self._rank_peak: dict[int, float] = {}
        self.steps_ingested = 0
        self.records_ingested = 0
        self.dropped_stale = 0  # dup/replayed records (chaos)
        self.clamped_negative = 0  # negative phase durations clamped to 0

    def add(self, rec: dict) -> bool:
        if not isinstance(rec, dict):
            return False
        step = rec.get("step")
        if isinstance(step, bool) or not isinstance(step, (int, float)):
            self.dropped_stale += 1
            return False
        step = int(step)
        rank = int(_num(rec.get("rank"), -1))
        if step <= self._last_step.get(rank, -1):
            self.dropped_stale += 1
            return False
        self._last_step[rank] = step

        wall = _num(rec.get("wall_s"))
        if wall < 0:
            self.clamped_negative += 1
            wall = 0.0
        phases: dict[str, float] = {}
        for phase in STEP_PHASES + SUB_PHASES:
            v = _num(rec.get(phase))
            if v < 0:
                self.clamped_negative += 1
                v = 0.0
            phases[phase] = v

        node_id = rec.get("node_id")
        if isinstance(node_id, str) and node_id:
            self._rank_node[rank] = node_id
        peak = peak_flops_per_chip(rec.get("device_kind"))
        if peak:
            self._rank_peak[rank] = peak * max(1, int(_num(rec.get("devices"), 1)))

        entry = self._by_step.get(step)
        if entry is None:
            entry = self._by_step[step] = {
                "walls": {},
                "ts": 0.0,
                "tokens": 0.0,
                "flops": 0.0,
                **{p: 0.0 for p in STEP_PHASES + SUB_PHASES},
            }
            self.steps_ingested += 1
            while len(self._by_step) > self.window:
                self._by_step.popitem(last=False)
        entry["walls"][rank] = wall
        entry["ts"] = max(entry["ts"], _num(rec.get("ts")))
        entry["tokens"] += _num(rec.get("tokens"))
        entry["flops"] += _num(rec.get("flops"))
        for phase in STEP_PHASES + SUB_PHASES:
            entry[phase] += phases[phase]
        self.records_ingested += 1
        return True

    # -- rolling throughput / breakdown ---------------------------------
    def summary(self) -> dict:
        """Gang-level rolling stats over the window: tokens/s, MFU (when
        the chip kind is known), and the phase breakdown as fractions of
        total per-rank step time."""
        steps = list(self._by_step.values())
        gang_wall = sum(
            max(e["walls"].values()) for e in steps if e["walls"]
        )
        tokens = sum(e["tokens"] for e in steps)
        flops = sum(e["flops"] for e in steps)
        rank_wall_total = sum(sum(e["walls"].values()) for e in steps)
        phase_fracs = {}
        for phase in STEP_PHASES:
            total = sum(e[phase] for e in steps)
            phase_fracs[phase.replace("_s", "_frac")] = (
                total / rank_wall_total if rank_wall_total > 0 else 0.0
            )
        # Sub-phase fracs (compute split) only when at least one rank
        # reported a split — an all-zero "fwd_frac: 0.0" would read as
        # "forward is free" rather than "no data".
        for phase in SUB_PHASES:
            total = sum(e.get(phase, 0.0) for e in steps)
            if total > 0 and rank_wall_total > 0:
                phase_fracs[phase.replace("_s", "_frac")] = (
                    total / rank_wall_total
                )
        peak_total = sum(self._rank_peak.values()) or None
        mfu = None
        if peak_total and gang_wall > 0:
            mfu = (flops / gang_wall) / peak_total
        return {
            "steps": self.steps_ingested,
            "window_steps": len(steps),
            "world_size": len(self._last_step),
            "tokens_per_s": tokens / gang_wall if gang_wall > 0 else 0.0,
            "flops_per_s": flops / gang_wall if gang_wall > 0 else 0.0,
            "mfu": mfu,
            **phase_fracs,
            "records": self.records_ingested,
            "dropped_stale": self.dropped_stale,
            "clamped_negative": self.clamped_negative,
        }

    # -- straggler detection --------------------------------------------
    def straggler_report(
        self,
        k: float = 3.0,
        min_steps: int = 8,
        min_fraction: float = 0.5,
    ) -> list[dict]:
        """Ranks persistently slower than the gang.

        Per step, a rank is flagged when its wall time exceeds
        ``median + k * MAD`` across the gang (MAD floored at 2% of the
        median so a perfectly uniform gang with float jitter never
        flags). A rank is a *straggler* when it was flagged in at least
        ``min_fraction`` of the last ``min_steps``-or-more multi-rank
        steps — one slow step is noise; a persistent offset is a sick
        host."""
        flagged: dict[int, int] = {}
        excess: dict[int, list[float]] = {}
        considered = 0
        for entry in self._by_step.values():
            walls = entry["walls"]
            if len(walls) < 2:
                continue
            considered += 1
            vals = list(walls.values())
            med = _median(vals)
            mad = _median([abs(v - med) for v in vals])
            floor = max(mad, 0.02 * med, 1e-6)
            threshold = med + k * floor
            for rank, wall in walls.items():
                if wall > threshold:
                    flagged[rank] = flagged.get(rank, 0) + 1
                    if med > 0:
                        excess.setdefault(rank, []).append(wall / med)
        if considered < min_steps:
            return []
        out = []
        for rank, count in sorted(flagged.items()):
            if count / considered >= min_fraction:
                ratios = excess.get(rank) or [1.0]
                out.append(
                    {
                        "rank": rank,
                        "node_id": self._rank_node.get(rank, ""),
                        "flagged_steps": count,
                        "window_steps": considered,
                        "excess_ratio": sum(ratios) / len(ratios),
                    }
                )
        return out


def goodput_buckets(
    wall_s: float,
    checkpoint_s: float = 0.0,
    restart_s: float = 0.0,
    stalled_s: float = 0.0,
) -> dict:
    """Classify an elastic run's wall clock.

    productive = wall − checkpoint − restart − stalled, so the four
    buckets sum to wall by construction. Bucket definitions:

      checkpoint : driver-side commit (StorageContext.persist) plus the
                   slowest rank's in-step save time per round
      restart    : gang (re)formation and restart backoff sleeps — the
                   resize/re-form tax
      stalled    : wall time between the last productive round and
                   failure detection — lost (uncommitted) work
      productive : everything else, i.e. training steps that committed
    """
    wall = max(0.0, float(wall_s))
    ckpt = min(wall, max(0.0, float(checkpoint_s)))
    restart = min(wall - ckpt, max(0.0, float(restart_s)))
    stalled = min(wall - ckpt - restart, max(0.0, float(stalled_s)))
    productive = wall - ckpt - restart - stalled
    return {
        "wall_s": wall,
        "productive_s": productive,
        "checkpoint_s": ckpt,
        "restart_s": restart,
        "stalled_s": stalled,
        "goodput_fraction": productive / wall if wall > 0 else 0.0,
    }
