"""Per-phase prover timing (the port's copy of halo_tpu/utils/timing.py's
RoundTimer): the reference logs each prover round's wall time and a
percentage breakdown (crates/plonk/src/plonk/protocol.rs:74-352).

Enabled when the HALO_TPU_TIMING environment variable is set or the
`halo_tpu_torch.timing` logger is at DEBUG; otherwise it records nothing.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger("halo_tpu_torch.timing")


def _enabled() -> bool:
    return bool(os.environ.get("HALO_TPU_TIMING")) or logger.isEnabledFor(logging.DEBUG)


class RoundTimer:
    """Named phase durations; one line per phase and a summary at report()."""

    def __init__(self, label: str):
        self.label = label
        self.enabled = _enabled()
        self.rounds: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        """Record the time since the previous mark (or construction) as
        phase `name`."""
        if not self.enabled:
            return
        now = time.perf_counter()
        prev = self._t0 + sum(dt for _, dt in self.rounds)
        self.rounds.append((name, now - prev))
        self._log(f"{self.label}: {name}: {self.rounds[-1][1]:.3f}s")

    def report(self) -> str:
        if not self.enabled:
            return ""
        total = time.perf_counter() - self._t0
        parts = ", ".join(
            f"{name} {dt:.2f}s ({100 * dt / total:.0f}%)" for name, dt in self.rounds)
        line = f"{self.label}: total {total:.3f}s [{parts}]"
        self._log(line)
        return line

    def _log(self, line: str) -> None:
        if os.environ.get("HALO_TPU_TIMING"):
            print(f"[timing] {line}", flush=True)
        logger.debug(line)
