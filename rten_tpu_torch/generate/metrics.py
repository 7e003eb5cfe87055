"""Generation metrics (reference: rten-generate/src/metrics.rs — warmup
vs steady tokens/sec, ms/token) extended with TTFT for serving."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    start_time: float = 0.0
    first_token_time: float | None = None
    step_times: list = field(default_factory=list)
    _last: float = 0.0

    def start(self):
        self.start_time = self._last = time.perf_counter()
        self.first_token_time = None
        self.step_times = []

    def step(self):
        now = time.perf_counter()
        if self.first_token_time is None:
            self.first_token_time = now - self.start_time
        self.step_times.append(now - self._last)
        self._last = now

    def step_n(self, n):
        """Record ``n`` tokens that arrived together (an on-device decode
        burst): the interval since the last step is split evenly, so
        tokens/sec math stays exact without n timestamp calls."""
        if n <= 0:
            return
        now = time.perf_counter()
        if self.first_token_time is None:
            self.first_token_time = now - self.start_time
        dt = (now - self._last) / n
        self.step_times.extend([dt] * n)
        self._last = now

    @property
    def ttft_s(self) -> float | None:
        return self.first_token_time

    @property
    def total_duration_s(self) -> float:
        return sum(self.step_times)

    @property
    def warmup_duration_s(self) -> float:
        """Time to the first token (compile + prefill)."""
        return self.step_times[0] if self.step_times else 0.0

    def tokens_per_second(self, include_warmup=False) -> float:
        times = self.step_times if include_warmup else self.step_times[1:]
        if not times:
            return 0.0
        return len(times) / sum(times)

    def ms_per_token(self) -> float:
        tps = self.tokens_per_second()
        return 1000.0 / tps if tps else float("inf")

    def summary(self) -> str:
        return (f"generated {len(self.step_times)} tokens; "
                f"ttft {1000 * (self.ttft_s or 0):.1f} ms; "
                f"{self.tokens_per_second():.1f} tokens/s steady "
                f"({self.ms_per_token():.2f} ms/token)")
