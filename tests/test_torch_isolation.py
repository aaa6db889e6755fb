"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry point never falls back to the CPU silently."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "arrow_ballista_tpu_torch")

_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import arrow_ballista_tpu_torch as abt
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES

import os, tempfile
import pyarrow.parquet as pq

ctx = abt.BallistaContext.local(device="cpu")
pctx = abt.BallistaContext.local(device="cpu")
tmp = tempfile.mkdtemp()
for name, table in generate_tables(0.002, seed=0).items():
    ctx.register_table(name, table)
    path = os.path.join(tmp, name + ".parquet")
    pq.write_table(table, path, row_group_size=2048)
    pctx.register_parquet(name, path)
df = ctx.sql(QUERIES[1]).to_pandas()
assert len(df) >= 3 and not df.isna().any().any(), df
# the parquet scan, the scan cache and the clustered aggregate
for _ in range(2):
    pdf = pctx.sql(QUERIES[18].replace("> 300", "> 100")).to_pandas()
assert len(pdf) > 0, pdf
# the standalone engine: stages, shuffle files, whole-stage fusion
sa = abt.BallistaContext.standalone(
    abt.BallistaConfig({{"ballista.shuffle.partitions": "4", "ballista.journal.enabled": "true"}}),
    device="cpu")
for name, path in [(n, os.path.join(tmp, n + ".parquet")) for n in ("lineitem", "orders", "customer")]:
    sa.register_parquet(name, path)
sdf = sa.sql(QUERIES[1]).to_pandas()
assert sdf.equals(pctx.sql(QUERIES[1]).to_pandas()), sdf
# observability (obs/) and fault injection (faults/)
from arrow_ballista_tpu_torch import faults
assert sa.doctor()["findings"] == [] and list(sa.watch())[-1]["state"] == "successful"
assert sa.explain_analyze(QUERIES[1])["rows_returned"] == len(df)
with faults.use_plan(faults.FaultPlan.from_obj({{"rules": [
        {{"site": "executor.memory.reserve", "action": "delay", "delay_ms": 0}}]}})):
    assert ctx.explain_analyze(QUERIES[1])["rows_returned"] == len(df)
sa.shutdown()
# the remote engine: a scheduler service, two executor servers, a session
from arrow_ballista_tpu_torch.executor.server import ExecutorServer
from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService
from arrow_ballista_tpu_torch.scheduler.scheduler import SchedulerConfig
svc = SchedulerNetService(device="cpu", scheduler_config=SchedulerConfig(
    task_distribution="round-robin"))
svc.start()
exs = [ExecutorServer("127.0.0.1", svc.port, work_dir=tempfile.mkdtemp(), device="cpu")
       for _ in range(2)]
for ex in exs:
    ex.start()
rctx = abt.BallistaContext.remote("127.0.0.1", svc.port, abt.BallistaConfig(
    {{"ballista.shuffle.partitions": "4"}}), device="cpu")
for name in ("lineitem", "orders", "customer"):
    rctx.register_parquet(name, os.path.join(tmp, name + ".parquet"))
assert rctx.sql(QUERIES[1]).to_pandas().equals(pctx.sql(QUERIES[1]).to_pandas())
rctx.shutdown()
for ex in exs:
    ex.stop(notify=False)
svc.stop()
# the memory governor and the spill paths (memory/), and EXTRACT
spill = abt.BallistaContext.local(abt.BallistaConfig({{
    "ballista.memory.host.budget.bytes": "4096", "ballista.join.broadcast_threshold": "0"}}),
    device="cpu")
for name, table in generate_tables(0.002, seed=0).items():
    spill.register_table(name, table)
from arrow_ballista_tpu_torch.memory import STATS
assert spill.sql(QUERIES[9]).to_pandas().equals(ctx.sql(QUERIES[9]).to_pandas())
assert STATS.snapshot().get("spill_runs_total", 0) > 0
import shutil
shutil.rmtree(tmp)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "arrow_ballista_tpu"
             or m.startswith("arrow_ballista_tpu."))
assert "jax" not in sys.modules and not bad, bad
print("ISOLATED", len(df))
"""


def test_port_runs_q1_without_importing_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "ISOLATED" in proc.stdout


def _port_files():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_port_file_imports_jax_or_the_reference():
    files = list(_port_files())
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {"compile/codegen.py", "compile/fused.py", "compile/fuse.py", "compile/chains.py",
            "scheduler/scheduler.py", "scheduler/standalone.py", "scheduler/aqe.py",
            "executor/executor.py", "models/ipc.py", "ops/shuffle.py",
            "memory/__init__.py", "memory/governor.py", "memory/spill.py",
            "faults/__init__.py", "executor/metrics.py", "scheduler/metrics.py",
            # the remote engine
            "serde.py", "native.py", "net/__init__.py", "net/wire.py", "net/retry.py",
            "net/rpc.py", "net/dataplane.py", "executor/server.py",
            "executor/flight_service.py", "client/remote.py", "scheduler/netservice.py",
            "scheduler/session.py", "utils/logsetup.py",
            *(f"obs/{m}.py" for m in ("__init__", "advisor", "device", "doctor", "http",
                                      "journal", "live", "profile", "progress", "slo",
                                      "stats", "trace_event", "tracing"))} <= rel
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "arrow_ballista_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    mods = [m.split(".")[0] for m in _imports(os.path.join(REPO, "chip_smoke.py"))]
    assert "jax" not in mods and "arrow_ballista_tpu" not in mods


def test_local_context_defaults_to_the_card_and_raises_without_one():
    from arrow_ballista_tpu_torch import BallistaContext

    if torch.cuda.is_available():
        assert BallistaContext.local().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BallistaContext.local()


def test_entry_defaults_to_the_card_and_raises_without_one():
    from arrow_ballista_tpu_torch import entry

    if torch.cuda.is_available():
        _step, (_cols, mask) = entry.entry(64)
        assert mask.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.entry(64)


def test_kernel_wrappers_refuse_mixed_devices():
    from arrow_ballista_tpu_torch.ops import kernels as K

    with pytest.raises(ValueError, match="CUDA device"):
        K._require_cuda(torch.zeros(4))


_MESH_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import arrow_ballista_tpu_torch as abt
from arrow_ballista_tpu_torch import entry
from arrow_ballista_tpu_torch.parallel import use_local_devices
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES

tables = generate_tables(0.002, seed=0)
plain = abt.BallistaContext.local(device="cpu")
mesh = abt.BallistaContext.local(abt.BallistaConfig({{
    "ballista.shuffle.mesh": "true", "ballista.shuffle.mesh.min_rows": "0",
    "ballista.join.broadcast_threshold": "0"}}), device="cpu")
for name, table in tables.items():
    plain.register_table(name, table)
    mesh.register_table(name, table)
with use_local_devices([torch.device("cpu")] * 4):
    for q in (1, 3):
        assert mesh.sql(QUERIES[q]).to_pandas().equals(plain.sql(QUERIES[q]).to_pandas()), q
    assert "Mesh" in mesh.last_plan.display(), mesh.last_plan.display()
assert entry.dryrun_multichip(2, device="cpu")["ok"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "arrow_ballista_tpu"
             or m.startswith("arrow_ballista_tpu."))
assert not bad, bad
print("MESH ISOLATED")
"""


def test_the_mesh_runs_without_importing_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _MESH_CHILD.format(repo=REPO)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "MESH ISOLATED" in proc.stdout


def test_the_mesh_modules_are_covered_by_the_import_check():
    rel = {os.path.relpath(f, PORT) for f in _port_files()}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
            "parallel/ici_shuffle.py", "parallel/distributed.py", "ops/mesh_exec.py"} <= rel
    for path in _port_files():
        if os.path.relpath(path, PORT).startswith("parallel") or path.endswith("mesh_exec.py"):
            assert not [m for m in _imports(path)
                        if m.split(".")[0] in ("jax", "jaxlib", "arrow_ballista_tpu")], path


def test_the_default_mesh_is_the_cards_and_raises_without_one():
    from arrow_ballista_tpu_torch.parallel import make_mesh, use_local_devices

    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with use_local_devices([torch.device("cpu")] * 3):
        assert make_mesh().devices == (torch.device("cpu"),) * 3
