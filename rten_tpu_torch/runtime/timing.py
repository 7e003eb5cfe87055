"""Per-op timing + run summaries.

A copy of ``rten_tpu/runtime/timing.py`` (the reference's
``src/timing.rs`` / ``RunTiming``): opt-in per-op records, aggregated by op
name (optionally by input shape), printed as a percentage table. On the
card the port's executor times each op with CUDA events (device time); on
the CPU with the host clock. ``total`` is the run's wall time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class TimingRecord:
    name: str
    elapsed: float
    input_shapes: tuple = ()


@dataclass
class RunTiming:
    records: list[TimingRecord] = field(default_factory=list)
    total: float = 0.0

    def add(self, name, elapsed, input_shapes=()):
        self.records.append(TimingRecord(name, elapsed, input_shapes))

    def op_seconds(self) -> float:
        """The ops' summed time."""
        return sum(r.elapsed for r in self.records)

    def summary(self, sort="time", by_shape=False) -> str:
        groups: dict[object, list[TimingRecord]] = {}
        for r in self.records:
            key = (r.name, r.input_shapes) if by_shape else r.name
            groups.setdefault(key, []).append(r)
        rows = []
        for key, recs in groups.items():
            name = f"{key[0]} {list(key[1])}" if by_shape else key
            t = sum(r.elapsed for r in recs)
            rows.append((name, t, len(recs)))
        if sort == "name":
            rows.sort(key=lambda r: str(r[0]))
        else:
            rows.sort(key=lambda r: -r[1])
        total = self.total or sum(r[1] for r in rows) or 1e-12
        lines = [f"{'op':<40} {'time(ms)':>10} {'%':>6} {'count':>6}"]
        for name, t, count in rows:
            lines.append(f"{str(name):<40} {t*1e3:>10.3f} {100*t/total:>6.2f} "
                         f"{count:>6}")
        lines.append(f"{'TOTAL':<40} {total*1e3:>10.3f} {'100.0':>6} "
                     f"{len(self.records):>6}")
        return "\n".join(lines)


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
