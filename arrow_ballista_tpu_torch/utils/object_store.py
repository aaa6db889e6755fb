"""Object-store registry: scheme-based filesystem resolution for scans.

The port's own copy of arrow_ballista_tpu/utils/object_store.py.  Upstream
Ballista resolves s3/oss/azure/hdfs URLs per scheme behind one
`BallistaObjectStoreRegistry` feeding DataFusion's object-store machinery
(reference ballista/core/src/utils.rs:88-174).  Here the registry resolves a
path/URL to a `pyarrow.fs.FileSystem` + in-store path, so every provider and
scan works identically against local disk, S3 (`s3://`), GCS (`gs://`),
HDFS (`hdfs://`), Azure (`az://`), or any custom scheme registered at
runtime (fsspec filesystems plug in via `register_fsspec`).

Paths keep their scheme end-to-end (catalog -> plan -> task), and IO sites
resolve lazily — the same discipline as the reference, where each scan
carries its object-store URL and executors resolve it locally.
"""
from __future__ import annotations

import posixpath
import re
from typing import Callable, Dict, List, Optional, Tuple

from .errors import ExecutionError

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

# custom scheme -> factory(url) -> (pyarrow FileSystem, path-inside-store)
_FACTORIES: Dict[str, Callable] = {}


def register_scheme(scheme: str, factory: Callable) -> None:
    """Register a resolver for ``scheme://`` URLs.

    ``factory(url) -> (pyarrow.fs.FileSystem, path)``.
    """
    _FACTORIES[scheme.lower()] = factory


def register_fsspec(scheme: str, fs) -> None:
    """Register an fsspec filesystem instance under a scheme (wrapped via
    pyarrow's FSSpecHandler so every scan path works against it)."""
    import pyarrow.fs as pafs

    wrapped = pafs.PyFileSystem(pafs.FSSpecHandler(fs))

    def factory(url: str):
        return wrapped, _strip_scheme(url)

    register_scheme(scheme, factory)


def scheme_of(path: str) -> Optional[str]:
    m = _SCHEME_RE.match(path)
    if m is None:
        return None
    s = m.group(1).lower()
    if len(s) == 1:  # windows drive letter, not a scheme
        return None
    return s


def _strip_scheme(url: str) -> str:
    return _SCHEME_RE.sub("", url)


_FS_CACHE: Dict[Tuple[str, str], object] = {}


def resolve(path: str):
    """path/URL -> (pyarrow FileSystem, in-store path).

    Filesystem clients are cached per (scheme, authority): a 500-file S3
    scan must not construct 500 S3FileSystem clients (credential/region
    resolution each time)."""
    import pyarrow.fs as pafs

    s = scheme_of(path)
    if s is None or s == "file":
        local = _strip_scheme(path) if s == "file" else path
        fs = _FS_CACHE.get(("file", ""))
        if fs is None:
            fs = _FS_CACHE[("file", "")] = pafs.LocalFileSystem()
        return fs, local
    factory = _FACTORIES.get(s)
    if factory is not None:
        return factory(path)
    inner = _strip_scheme(path)
    authority = inner.split("/", 1)[0]
    fs = _FS_CACHE.get((s, authority))
    if fs is not None:
        return fs, inner
    try:
        # pyarrow understands s3://, gs://, hdfs://, az:// natively
        fs, p = pafs.FileSystem.from_uri(path)
        _FS_CACHE[(s, authority)] = fs
        return fs, p
    except Exception:
        pass
    try:
        # fsspec covers the long tail (http, memory, ftp, ...)
        import fsspec

        fs = pafs.PyFileSystem(pafs.FSSpecHandler(fsspec.filesystem(s)))
        _FS_CACHE[(s, authority)] = fs
        return fs, inner
    except Exception as e:  # noqa: BLE001
        raise ExecutionError(f"no object store registered for scheme "
                             f"{s!r} ({path}): {e}") from e


def _rejoin(original: str, inner: str) -> str:
    s = scheme_of(original)
    return f"{s}://{inner}" if s is not None and s != "file" else inner


def is_dir(path: str) -> bool:
    import pyarrow.fs as pafs

    fs, p = resolve(path)
    try:
        return fs.get_file_info(p).type == pafs.FileType.Directory
    except Exception:  # noqa: BLE001
        return False


def list_files(path: str, suffixes: Tuple[str, ...]) -> List[str]:
    """Expand a directory URL to its matching files (scheme preserved);
    a file URL passes through as a singleton."""
    import pyarrow.fs as pafs

    fs, p = resolve(path)
    info = fs.get_file_info(p)
    if info.type == pafs.FileType.Directory:
        sel = pafs.FileSelector(p, recursive=False)
        out = sorted(
            f.path for f in fs.get_file_info(sel)
            if f.type == pafs.FileType.File
            and any(f.path.endswith(sfx) for sfx in suffixes))
        return [_rejoin(path, f) for f in out]
    if info.type == pafs.FileType.File:
        return [path]
    # not found: pass through as a single file and let the read fail with a
    # clear error — plans must stay constructible/serde-round-trippable on
    # machines that don't hold the data (the reference ships plans whose
    # object-store URLs only resolve on executors)
    return [path]


def open_input(path: str):
    """Random-access input file handle (works for parquet/csv readers)."""
    fs, p = resolve(path)
    return fs.open_input_file(p)


def parquet_file(path: str, read_dictionary=None):
    import pyarrow.parquet as pq

    fs, p = resolve(path)
    return pq.ParquetFile(p, filesystem=fs, read_dictionary=read_dictionary)


def read_parquet_row_groups(path: str, row_groups, columns,
                            read_dictionary=None):
    """``read_dictionary``: column names to decode as DictionaryArray
    straight from the parquet pages (the engine dictionary-codes its string
    columns anyway, so the scan skips a re-encode pass)."""
    with parquet_file(path, read_dictionary=read_dictionary) as pf:
        return pf.read_row_groups(row_groups, columns=columns)
