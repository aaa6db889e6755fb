"""Local parquet files for the scans and the catalog.

The reference resolves every path through an object-store registry
(arrow_ballista_tpu/utils/object_store.py: s3, gs, hdfs, az and fsspec
schemes).  The port reads local paths only: a URL with a scheme raises
until object stores are ported (ROADMAP.md queue 1 item 4).
"""
from __future__ import annotations

import os
import re
from typing import List, Tuple

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def local_path(path: str) -> str:
    """``path`` as a local filesystem path; ``file://`` is stripped, any
    other scheme raises NotImplementedError."""
    m = _SCHEME_RE.match(path)
    if m is None:
        return path
    if m.group(1).lower() == "file":
        return path[m.end():]
    raise NotImplementedError(
        f"object-store paths ({m.group(1)}://) are not ported yet; the port reads "
        "local files only (ROADMAP.md queue 1 item 4)")


def list_files(path: str, suffixes: Tuple[str, ...]) -> List[str]:
    """A directory expands to its matching files (sorted, not recursive);
    a file, or a path that does not exist yet, passes through as itself
    (the read then fails with a clear error)."""
    p = local_path(path)
    if os.path.isdir(p):
        return sorted(os.path.join(p, f) for f in os.listdir(p)
                      if f.endswith(suffixes) and os.path.isfile(os.path.join(p, f)))
    return [p]


def parquet_file(path: str, read_dictionary=None):
    import pyarrow.parquet as pq

    return pq.ParquetFile(local_path(path), read_dictionary=read_dictionary)


def read_parquet_row_groups(path: str, row_groups, columns, read_dictionary=None):
    """``read_dictionary``: string columns to decode as DictionaryArray
    straight from the parquet pages (the engine dictionary-codes them
    anyway, so the scan skips a re-encode pass)."""
    with parquet_file(path, read_dictionary=read_dictionary) as pf:
        return pf.read_row_groups(row_groups, columns=columns)
