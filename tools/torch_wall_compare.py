"""Warm walls of chosen ``chip_smoke.py`` paths for one checkout of the
PyTorch/CUDA port, so that two commits can be compared in one call on one
card.

    python3 tools/torch_wall_compare.py --root DIR --data DIR [--runs 7]
        [--paths q3,pq_q4,pq_q7,sa_pq_q18]

``--root`` is a checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); the data
and the queries come from this repo's ``benchmarks/``.  TPC-H SF1 from
seed 0 is generated on the first run and kept in ``--data`` (the tables
as Arrow IPC for the in-memory paths, parquet as ``chip_smoke.py`` writes
it), so later runs read it back.  Each path runs once cold and ``--runs``
times warm (``sql`` -> ``to_pandas``, then a device synchronize, on the
host clock), with the contexts and configurations of ``chip_smoke.py``:
the local engine with its defaults, and the standalone one with 'auto'
shuffle partitions, 2^20-row batches and four task slots.  A path is
``q<n>`` (local, in memory), ``pq_q<n>`` (local, parquet), ``sa_q<n>``
(standalone, in memory) or ``sa_pq_q<n>`` (standalone, parquet).  Prints one
JSON line: ``{"root", "device", "paths": {path: {"cold_ms", "warm_ms",
"median_ms", "rows"}}}``.  With ``--profile OUT`` the warm runs of each
path also run under cProfile, and OUT gets the 30 functions with the most
own time, per path (host time: where the walls go when the card idles).
Needs a card; run parent, change, change, parent in one call and compare
the medians.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation",
          "region")
ROW_GROUP_ROWS = 1 << 19  # chip_smoke.py ROW_GROUP_ROWS at SF1


def _data(directory: str, sf: float):
    """{table: in-memory arrow table}, {table: parquet path}."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(directory, exist_ok=True)
    done = os.path.join(directory, "done")
    if not os.path.exists(done):
        from benchmarks.datagen import generate_tables
        from benchmarks.tpch import decimal_to_int64_storage

        tables = generate_tables(sf, seed=0)
        for name in TABLES:
            with pa.ipc.new_file(os.path.join(directory, f"{name}.arrow"),
                                 tables[name].schema) as w:
                w.write_table(tables[name])
            pq.write_table(decimal_to_int64_storage(tables[name]),
                           os.path.join(directory, f"{name}.parquet"), compression="zstd",
                           row_group_size=max(1024, int(ROW_GROUP_ROWS * sf)))
        open(done, "w").close()
    mem = {n: pa.ipc.open_file(os.path.join(directory, f"{n}.arrow")).read_all()
           for n in TABLES}
    return mem, {n: os.path.join(directory, f"{n}.parquet") for n in TABLES}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--paths", default="q1,q3,q4,pq_q1,pq_q3,pq_q4,pq_q7,pq_q18,sa_pq_q1,"
                                       "sa_pq_q18")
    ap.add_argument("--profile", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)  # benchmarks/
    sys.path.insert(0, root)  # the port under test comes first

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this comparison runs on the card")
    import arrow_ballista_tpu_torch as port
    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
    from arrow_ballista_tpu_torch.ops import _cuda

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        sys.exit(f"imported the port from {port.__file__}, not from {root}")
    from benchmarks.queries import QUERIES

    _cuda.LIBRARIES.build_all()  # the hand-written kernels, outside the walls
    mem, pq_paths = _data(os.path.abspath(args.data), args.sf)
    device = torch.device("cuda")
    local_mem = BallistaContext.local(device=device)
    for name, table in mem.items():
        local_mem.register_table(name, table)
    local_pq = BallistaContext.local(device=device)
    sa_cfg = {"ballista.shuffle.partitions": "auto", "ballista.batch.size": str(1 << 20)}
    sa_pq = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                       device=device)
    sa_mem = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                        device=device)
    for name, path in pq_paths.items():
        local_pq.register_parquet(name, path)
        sa_pq.register_parquet(name, path)
        sa_mem.register_table(name, mem[name])
    q18 = QUERIES[18].replace("> 300", "> 300" if args.sf >= 1 else "> 200")
    out = {"root": root, "device": torch.cuda.get_device_name(0), "paths": {}}
    try:
        for path in args.paths.split(","):
            engine, _, q = path.rpartition("_")
            ctx = {"": local_mem, "pq": local_pq, "sa_pq": sa_pq, "sa": sa_mem}[engine]
            sql = q18 if q == "q18" else QUERIES[int(q[1:])]
            walls = []
            rows = None
            prof = cProfile.Profile() if args.profile else None
            for run in range(args.runs + 1):
                if prof is not None and run == 1:
                    prof.enable()
                t0 = time.perf_counter()
                df = ctx.sql(sql).to_pandas()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1000)
                rows = len(df)
            if prof is not None:
                prof.disable()
                text = io.StringIO()
                pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(30)
                with open(args.profile, "a") as f:
                    f.write(f"== {root} {path}: {args.runs} warm runs\n{text.getvalue()}\n")
            out["paths"][path] = {"cold_ms": walls[0], "warm_ms": walls[1:],
                                  "median_ms": statistics.median(walls[1:]), "rows": rows}
    finally:
        sa_pq.shutdown()
        sa_mem.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
