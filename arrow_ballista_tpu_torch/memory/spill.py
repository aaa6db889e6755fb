"""Spill-to-disk runs: Arrow IPC files written under the task work dir.

Mirrors arrow_ballista_tpu/memory/spill.py.  When the governor denies a
reservation, an operator writes its state as IPC *runs* (models/ipc.py —
the same writer and reader the shuffle files use, so dictionary pruning,
int64 narrowing and the unified sorted dictionaries on read are shared)
and merges them on read.  Every run records the CRC-32 of the bytes it put
on disk; the read path re-hashes before decoding, so corruption on disk
surfaces as a retryable :class:`~..utils.errors.IntegrityError` and never
as wrong rows.

Every run write passes the ``executor.spill.write`` failpoint (faults/):
``raise`` is a spill I/O failure, ``corrupt`` flips bytes on disk after
the CRC, so the read-back check must catch it.
"""
from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import faults
from ..models.ipc import crc32_file, read_ipc_files, write_ipc_rows
from ..models.schema import Schema
from ..utils.errors import IntegrityError
from .governor import STATS


class SpillRun:
    """One spilled IPC file and the checksum its reader must see."""

    __slots__ = ("path", "crc", "num_rows", "num_bytes")

    def __init__(self, path: str, crc: int, num_rows: int, num_bytes: int):
        self.path = path
        self.crc = crc
        self.num_rows = num_rows
        self.num_bytes = num_bytes

    def __repr__(self):
        return (f"SpillRun({os.path.basename(self.path)}, rows={self.num_rows}, "
                f"bytes={self.num_bytes})")


class Spiller:
    """Writes and reads the spill runs of one operator execution.

    Files live under ``<work_dir>/<job_id>/spill/<tag>-<unique>/``, so
    concurrent tasks of one job never collide and ``cleanup()`` removes
    the whole directory."""

    def __init__(self, work_dir: str, job_id: str = "", tag: str = "op"):
        self.dir = os.path.join(work_dir, job_id or "_adhoc", "spill",
                                f"{tag}-{uuid.uuid4().hex[:12]}")
        self._seq = 0
        self._lock = threading.Lock()
        self.runs: List[SpillRun] = []

    # --- write ----------------------------------------------------------
    def write_run(self, schema: Schema, data: Dict[str, np.ndarray],
                  dicts: Dict[str, np.ndarray]) -> SpillRun:
        """Spill already-compacted host rows as one IPC run."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"run-{seq}.arrow")
        rule = faults.inject("executor.spill.write", path=path)
        num_rows, num_bytes = write_ipc_rows(schema, data, dicts, path)
        crc = crc32_file(path)
        if rule is not None and rule.action == "corrupt":
            # after the CRC: the reader's integrity check must catch it
            with open(path, "rb") as fh:
                raw = fh.read()
            with open(path, "wb") as fh:
                fh.write(faults.corrupt_bytes(raw))
        run = SpillRun(path, crc, num_rows, num_bytes)
        with self._lock:
            self.runs.append(run)
        STATS.add("spill_runs_total")
        STATS.add("spill_bytes_total", num_bytes)
        return run

    def write_batch(self, batch) -> SpillRun:
        """Spill a device batch's live rows (one packed device->host copy)."""
        return self.write_run(batch.schema, batch.compacted_numpy(), batch.dicts)

    # --- read -----------------------------------------------------------
    def read(self, schema: Schema, runs: Optional[Sequence[SpillRun]] = None,
             device="cuda") -> List:
        """Read runs back into batches on ``device`` (one unified sorted
        dictionary per string column, as the shuffle read path).  Every
        run's CRC is verified first; a mismatch is retryable, and the retry
        recomputes from the task's inputs."""
        runs = self.runs if runs is None else list(runs)
        for run in runs:
            actual = crc32_file(run.path)
            if actual != run.crc:
                raise IntegrityError("executor.spill.read",
                                     "spill run failed CRC verification on read-back",
                                     path=run.path, expected=run.crc, actual=actual)
        return read_ipc_files([r.path for r in runs], schema, device=device)

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        with self._lock:
            self.runs = []
