"""Memory-pressure plane of the port.

Mirrors arrow_ballista_tpu/memory/:

- :mod:`.governor` — per-executor reserve/grant/release accounting over a
  host budget; a denial sends the operator down its spill path.
- :mod:`.spill` — Arrow IPC spill runs with CRC-verified read-back,
  written when a reservation is denied and merged on read.
"""
from .governor import STATS, MemoryGovernor, Reservation
from .spill import Spiller, SpillRun

__all__ = ["MemoryGovernor", "Reservation", "Spiller", "SpillRun", "STATS"]
