"""The port's memory governor and spill paths (arrow_ballista_tpu_torch/
memory/) on the CPU, against the JAX package's.

- the governor's accounting cases of the reference's tests/test_memory.py
  (reserve, deny, try_reserve as the spill signal, force_reserve, the
  context manager, from_config, concurrent reservations) and its spill-run
  cases (round trip, CRC corruption caught on read), without the
  failpoint cases, which wait for the port of ``faults/``;
- K16's twin (``spill_partition_plain``) equals the top bits of the JAX
  package's ``hash64``, forced collisions included;
- spilled grouped aggregation and hash joins are bit-identical to the
  in-memory run under a budget that denies every materialization, and to
  the JAX package's spilled run; a spilled inner join keeps the unspilled
  output order, string build columns included; the aggregate and the join
  both record their spill runs; no reservation leaks.
"""
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jab
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch import BallistaConfig as TConfig
from arrow_ballista_tpu_torch import BallistaContext as TContext
from arrow_ballista_tpu_torch.memory import STATS, MemoryGovernor, Reservation
from arrow_ballista_tpu_torch.memory.spill import Spiller
from arrow_ballista_tpu_torch.models.schema import INT64, Field, Schema
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.utils.config import MEM_HOST_BUDGET, MEM_SPILL_ENABLED
from arrow_ballista_tpu_torch.utils.errors import IntegrityError, MemoryExhausted
from tests.torch_cases import HASH_CASES, hash_cols, plan_nodes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_stats():
    """The process-global STATS must not leak between tests."""
    STATS.reset()
    yield
    STATS.reset()


# --------------------------------------------------------------------------
# governor accounting
# --------------------------------------------------------------------------


def test_unlimited_budget_always_grants_and_accounts():
    gov = MemoryGovernor()  # budget 0 = unlimited
    assert gov.available() is None
    r = gov.reserve(1 << 30, site="unit")
    assert gov.reserved() == 1 << 30
    assert STATS.snapshot()["reserved_bytes.host"] == 1 << 30
    r.release()
    assert gov.reserved() == 0
    r.release()  # idempotent
    assert gov.reserved() == 0
    assert STATS.snapshot()["reserved_bytes.host"] == 0


def test_budgeted_reserve_denial_and_pressure():
    gov = MemoryGovernor(host_budget=1000)
    a = gov.reserve(600, site="op-a")
    assert gov.available() == 400
    with pytest.raises(MemoryExhausted):
        gov.reserve(500, site="op-b")
    assert gov.reserved() == 600, "a denied reservation must not leak"
    b = gov.reserve(400, site="op-b")
    assert gov.available() == 0
    a.release()
    b.release()
    assert gov.available() == 1000


def test_try_reserve_denial_is_the_spill_signal():
    gov = MemoryGovernor(host_budget=100)
    assert isinstance(gov.try_reserve(100), Reservation)
    assert gov.try_reserve(1) is None, "None tells the operator to take its spill path"
    assert STATS.snapshot()["reserve_denied_total"] == 1


def test_try_reserve_reraises_with_spill_disabled():
    gov = MemoryGovernor(host_budget=100, spill_enabled=False)
    gov.reserve(100)
    with pytest.raises(MemoryExhausted) as exc:
        gov.try_reserve(50, site="agg-state")
    assert exc.value.retryable, "a denial that cannot degrade to spill stays retryable"
    assert STATS.snapshot()["reserve_denied_total"] == 1


def test_force_reserve_overshoots_and_counts():
    gov = MemoryGovernor(host_budget=100)
    r = gov.force_reserve(250, site="left-outer-build")
    assert gov.reserved() == 250
    assert gov.available() == -150, "the overshoot shows in what is left"
    assert STATS.snapshot()["over_budget_grants_total"] == 1
    r.release()
    gov.force_reserve(10).release()  # within budget: not counted
    assert STATS.snapshot()["over_budget_grants_total"] == 1


def test_reservation_context_manager_unwinds():
    gov = MemoryGovernor(host_budget=100)
    with pytest.raises(RuntimeError):
        with gov.reserve(80):
            assert gov.reserved() == 80
            raise RuntimeError("operator blew up")
    assert gov.reserved() == 0


def test_from_config_budgets_and_spill_knob():
    gov = MemoryGovernor.from_config(TConfig({MEM_HOST_BUDGET: "4096",
                                              MEM_SPILL_ENABLED: "false"}))
    assert gov.budget() == 4096
    assert gov.spill_enabled is False
    auto = MemoryGovernor.from_config(TConfig({MEM_HOST_BUDGET: "auto"}))
    assert auto.budget() > (1 << 30), "'auto' resolves a real budget"


def test_device_budget_waits_for_the_admission_controller():
    """The reference's device pool only feeds the heartbeat pressure that
    its admission controller reads; neither is ported yet, so the key is
    refused rather than read and ignored."""
    from arrow_ballista_tpu_torch.utils.errors import ConfigurationError

    with pytest.raises(ConfigurationError, match="unknown configuration key"):
        TConfig({"ballista.memory.device.budget.bytes": "auto"})


def test_concurrent_reservations_race():
    budget = 10_000
    gov = MemoryGovernor(host_budget=budget)
    errors, granted = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            n = int(rng.integers(1, 4000))
            r = gov.try_reserve(n, site=f"w{seed}")
            if r is None:
                continue
            held = gov.reserved()
            if held > budget:
                errors.append(f"oversubscribed: {held} > {budget}")
            granted.append(n)
            r.release()

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    assert granted, "some reservations must have been granted"
    assert gov.reserved() == 0, "every grant must release"
    assert STATS.snapshot()["reserved_bytes.host"] == 0


# --------------------------------------------------------------------------
# spill runs: IPC round trip and CRC integrity
# --------------------------------------------------------------------------


def _spill_schema():
    return Schema([Field("g", INT64), Field("v", INT64)])


def test_spiller_round_trip(tmp_path):
    sp = Spiller(str(tmp_path), job_id="j1", tag="agg")
    schema = _spill_schema()
    sp.write_run(schema, {"g": np.array([1, 2], dtype=np.int64),
                          "v": np.array([10, 20], dtype=np.int64)}, {})
    sp.write_run(schema, {"g": np.array([3], dtype=np.int64),
                          "v": np.array([30], dtype=np.int64)}, {})
    batches = sp.read(schema, device="cpu")
    got = pd.concat([b.to_pandas() for b in batches], ignore_index=True)
    pd.testing.assert_frame_equal(got, pd.DataFrame({"g": [1, 2, 3], "v": [10, 20, 30]}),
                                  check_dtype=False)
    snap = STATS.snapshot()
    assert snap["spill_runs_total"] == 2
    assert snap["spill_bytes_total"] > 0
    sp.cleanup()
    assert sp.runs == []


def test_spill_corruption_detected_on_read(tmp_path):
    sp = Spiller(str(tmp_path), job_id="j1", tag="agg")
    schema = _spill_schema()
    run = sp.write_run(schema, {"g": np.arange(100, dtype=np.int64),
                                "v": np.arange(100, dtype=np.int64)}, {})
    with open(run.path, "r+b") as fh:  # silent bit rot after the CRC
        fh.seek(32)
        fh.write(b"\xff")
    with pytest.raises(IntegrityError) as exc:
        sp.read(schema, device="cpu")
    assert exc.value.retryable, "spill corruption is recoverable, so retryable"


# --------------------------------------------------------------------------
# K16's twin against the reference's "join.spill_part"
# --------------------------------------------------------------------------


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", HASH_CASES)
def test_spill_partition_twin_equals_the_reference_top_bits(case, forced):
    import jax.numpy as jnp

    cols = hash_cols(case, 3000, np.random.default_rng(11))
    jwas, twas = JK._FORCE_COLLISIONS, TK._FORCE_COLLISIONS
    JK._FORCE_COLLISIONS = TK._FORCE_COLLISIONS = forced
    try:
        h = JK.hash64([jnp.asarray(c) for c in cols])
        want = np.asarray(((h >> (64 - 3)) & 7).astype(jnp.int32))
        got = TK.spill_partition([torch.from_numpy(c) for c in cols], 8).numpy()
    finally:
        JK._FORCE_COLLISIONS, TK._FORCE_COLLISIONS = jwas, twas
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    if forced:
        assert (got == 0).all()


def test_spill_partition_rejects_a_count_that_is_not_a_power_of_two():
    with pytest.raises(ValueError):
        TK.spill_partition([torch.arange(4)], 6)


# --------------------------------------------------------------------------
# K16's ordered form (spill_order) against the reference's part_fn and a
# stable argsort, and a numpy model of its kernels' packed arithmetic
# --------------------------------------------------------------------------

SPILL_MASKS = ["random", "all_live", "all_dead"]


def _reference_spill_order(cols, mask, parts):
    """The reference's part_fn composition: the top bits of JK.hash64, then
    numpy's stable argsort on (dead, partition)."""
    import jax.numpy as jnp

    bits = parts.bit_length() - 1
    h = JK.hash64([jnp.asarray(c) for c in cols])
    part = np.asarray(((h >> (64 - bits)) & (parts - 1)).astype(jnp.int32))
    order = np.argsort((~mask).astype(np.int64) * parts + part, kind="stable").astype(np.int32)
    return part, order, int(mask.sum())


def _spill_mask(case, n, rng):
    return {"random": rng.random(n) < 0.6, "all_live": np.ones(n, bool),
            "all_dead": np.zeros(n, bool)}[case]


@pytest.mark.parametrize("parts", [2, 8])
@pytest.mark.parametrize("mask_case", SPILL_MASKS)
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", HASH_CASES)
def test_spill_order_twin_equals_the_reference(case, forced, mask_case, parts):
    rng = np.random.default_rng(12)
    cols = hash_cols(case, 3000, rng)
    mask = _spill_mask(mask_case, 3000, rng)
    jwas, twas = JK._FORCE_COLLISIONS, TK._FORCE_COLLISIONS
    JK._FORCE_COLLISIONS = TK._FORCE_COLLISIONS = forced
    try:
        want = _reference_spill_order(cols, mask, parts)
        part, order, count = TK.spill_order([torch.from_numpy(c) for c in cols],
                                            torch.from_numpy(mask), parts)
        plain = TK.spill_order_plain([torch.from_numpy(c) for c in cols], torch.from_numpy(mask),
                                     parts)
        alone = TK.spill_partition_plain([torch.from_numpy(c) for c in cols], parts)
    finally:
        JK._FORCE_COLLISIONS, TK._FORCE_COLLISIONS = jwas, twas
    for got in ((part, order, count), plain):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
        assert int(got[2]) == want[2] and got[2].shape == (1,)
    np.testing.assert_array_equal(part.numpy(), alone.numpy())


_M64 = (1 << 64) - 1
_NONE = 0xFF  # csrc/compact.cu SO_NONE


def _field(words, b):
    return (words[b >> 2] >> (16 * (b & 3))) & 0xFFFF


def _so_round_model(buckets, r0, nb, nxt, perm, threads, rows=8):
    """csrc/compact.cu's round (so_hash's counts, so_block_scan, so_place)
    in Python ints, ``rows`` a thread: each thread's counts packed
    four to a 64-bit word, the block scan, the round's bucket offsets from
    the packed totals, the staged slots and the destinations."""
    q_words = 4  # SO_Q
    cnt = []
    for t in range(threads):
        c = [0] * q_words
        for k in range(rows):
            bk = int(buckets[rows * t + k])
            if bk != _NONE:
                c[bk >> 2] = (c[bk >> 2] + (1 << (16 * (bk & 3)))) & _M64
        cnt.append(c)
    ex, run = [], [0] * q_words
    for c in cnt:
        ex.append(list(run))
        run = [(a + b) & _M64 for a, b in zip(run, c)]
    tot = run
    for q in range(q_words):  # no field may overflow
        for f in range(4):
            assert (tot[q] >> (16 * f)) & 0xFFFF == sum(((c[q] >> (16 * f)) & 0xFFFF)
                                                         for c in cnt)
    carry, base = 0, []
    for q in range(q_words):
        t = tot[q]
        incl = (t + (t << 16) + (t << 32) + (t << 48)) & _M64
        base.append((incl - t + carry * 0x0001000100010001) & _M64)
        carry = (carry + (incl >> 48)) & _M64
    dst = {}
    for b in range(nb):
        dst[b] = nxt[b] - _field(base, b)
        nxt[b] += _field(tot, b)
    stage, stage_b = {}, {}
    for t in range(threads):
        mine = [(a + e) & _M64 for a, e in zip(base, ex[t])]
        for k in range(rows):
            bk = int(buckets[rows * t + k])
            if bk == _NONE:
                continue
            slot = _field(mine, bk)
            mine[bk >> 2] = (mine[bk >> 2] + (1 << (16 * (bk & 3)))) & _M64
            stage[slot], stage_b[slot] = r0 + rows * t + k, bk
    assert sorted(stage) == list(range(carry))
    for i in range(carry):
        perm[dst[stage_b[i]] + i] = stage[i]


def _so_model(part, mask, parts, threads):
    """K16's ordered form over the buckets (p if live, P + p if dead): tiles
    of one round, each starting each bucket after the bucket's rows in the
    tiles before (what both forms work out from every tile's counts: the
    one-launch form after its grid barrier, the two-launch form in its
    second launch); the rounds through _so_round_model.  ``threads`` shrinks
    the tiles so that a small input spans several of them."""
    n = len(part)
    nb = 2 * parts
    buckets = np.where(mask, part, parts + part).astype(np.int64)
    perm = np.full(n, -1, np.int64)
    rb = 8 * threads  # SO_CO_ROWS
    blocks = -(-n // rb)
    padded = np.full(blocks * rb, _NONE, np.int64)
    padded[:n] = buckets
    hist = [np.bincount(padded[b * rb:(b + 1) * rb][padded[b * rb:(b + 1) * rb] != _NONE],
                        minlength=nb) for b in range(blocks)]
    totals = np.sum(hist, axis=0)
    start = np.concatenate([[0], np.cumsum(totals)[:-1]])
    for b in range(blocks):
        before = np.sum(hist[:b], axis=0) if b else np.zeros(nb, np.int64)
        nxt = {q: int(start[q] + before[q]) for q in range(nb)}
        _so_round_model(padded[b * rb:(b + 1) * rb], b * rb, nb, nxt, perm, threads)
    assert (perm >= 0).all()
    return perm.astype(np.int32), int(totals[:parts].sum())


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("mask_case", SPILL_MASKS)
def test_spill_order_kernel_model_matches_the_twin(mask_case, parts):
    """The kernels' packed 16-bit counts, scans, offsets and destinations
    in numpy (blocks of 8 and 16 threads, so that 3,001 rows span several
    blocks and rounds) against the twin's order and count."""
    rng = np.random.default_rng(13)
    n = 3001
    keys = [torch.from_numpy(rng.integers(-2**40, 2**40, n).astype(np.int64))]
    mask = _spill_mask(mask_case, n, rng)
    part, order, count = TK.spill_order_plain(keys, torch.from_numpy(mask), parts)
    for threads in (8, 16, 256):
        got, live = _so_model(part.numpy(), mask, parts, threads)
        np.testing.assert_array_equal(got, order.numpy())
        assert live == int(count)


def test_spill_split_runs_equal_the_parents_masks():
    """The spill split's runs: slices of the partition-grouped pack hold
    exactly the rows, in the same order, as the parent's per-partition
    masks over the row-ordered pack (string, float and bool columns)."""
    from arrow_ballista_tpu_torch.models.batch import ColumnBatch
    from arrow_ballista_tpu_torch.models.schema import BOOL, FLOAT64, INT32

    rng = np.random.default_rng(14)
    n = 5000
    schema = Schema([Field("k", INT64), Field("x", FLOAT64), Field("c", INT32), Field("b", BOOL)])
    cols = {"k": torch.from_numpy(rng.integers(0, 300, n).astype(np.int64)),
            "x": torch.from_numpy(rng.normal(size=n)),
            "c": torch.from_numpy(rng.integers(-1, 20, n).astype(np.int32)),
            "b": torch.from_numpy(rng.random(n) < 0.5)}
    mask = torch.from_numpy(rng.random(n) < 0.7)
    batch = ColumnBatch(schema, cols, mask, {})
    keys = [cols["k"]]
    # the parent: the partition alone, the row-ordered pack, a mask a partition
    pcols, _ = batch.packed_numpy(extra32={"__part": TK.spill_partition(keys, 8)})
    pids = pcols.pop("__part")
    part, order, count = TK.spill_order(keys, mask, 8)
    ncols, nrows = ColumnBatch(schema, cols, mask, {}).packed_numpy(
        extra32={"__part": part}, order=(order, count))
    sorted_ids = ncols.pop("__part")
    assert nrows == int(mask.sum()) and (np.diff(sorted_ids) >= 0).all()
    bounds = np.searchsorted(sorted_ids, np.arange(9))
    for p in range(8):
        sel = pids == p
        for name in cols:
            np.testing.assert_array_equal(ncols[name][bounds[p]:bounds[p + 1]], pcols[name][sel])


# --------------------------------------------------------------------------
# spilled execution is bit-identical to in-memory
# --------------------------------------------------------------------------

QUERIES = (
    # grouped aggregation: sum/count/min/max state spills per input batch
    "select g, sum(v) as s, count(*) as n, min(v) as lo, max(v) as hi "
    "from t group by g order by g",
    # hash join: the build side spills as hash partitions
    "select t.g, sum(t.v + d.w) as s from t join d on t.g = d.g "
    "group by t.g order by t.g",
    # semi and anti ride the probe-mask merge
    "select count(*) as n from t where g in (select g from d where w > 50)",
    "select count(*) as n from t where g not in (select g from d)",
)
# no ORDER BY: the spilled inner join must keep the in-memory output order
ORDER_SQL = "select t.g, t.v, d.w, d.name from t join d on t.g = d.g"


def _tables():
    rng = np.random.default_rng(23)
    t = pa.table({"g": pa.array(rng.integers(0, 40, 6000).astype(np.int64)),
                  "v": pa.array(rng.integers(0, 1000, 6000).astype(np.int64))})
    d = pa.table({"g": pa.array(np.arange(0, 25, dtype=np.int64)),
                  "w": pa.array(rng.integers(0, 100, 25).astype(np.int64)),
                  "name": pa.array([f"n{int(x):03d}" for x in rng.integers(0, 60, 25)])})
    return {"t": t, "d": d}


def _ctx(pkg, budget=None):
    conf = {"ballista.shuffle.partitions": "4", "ballista.join.broadcast_threshold": "0",
            "ballista.batch.size": "1024"}
    if budget is not None:
        conf[MEM_HOST_BUDGET] = str(budget)
    if pkg == "jax":
        c = jab.BallistaContext.local(jab.BallistaConfig(conf))
    else:
        c = TContext.local(TConfig(conf), device="cpu")
    for name, table in _tables().items():
        c.register_table(name, table)
    return c


def _spill_metrics(plan):
    """{operator class name: spill runs} over a plan's operators."""
    out = {}
    for node in plan_nodes(plan):
        runs = node.metrics().to_dict().get("spill_runs", 0)
        if runs:
            out[type(node).__name__] = out.get(type(node).__name__, 0) + runs
    return out


def test_forced_spill_results_bit_identical():
    base = [_ctx("torch").sql(q).to_pandas() for q in QUERIES]
    assert STATS.snapshot().get("spill_runs_total", 0) == 0, "the baseline must not spill"
    tiny = _ctx("torch", budget=2048)  # denies every materialization
    got, spilled = [], {}
    for q in QUERIES:
        got.append(tiny.sql(q).to_pandas())
        for k, v in _spill_metrics(tiny.last_plan).items():
            spilled[k] = spilled.get(k, 0) + v
    snap = STATS.snapshot()
    assert snap["reserve_denied_total"] > 0
    assert snap["spill_runs_total"] > 0, "the tiny budget must force spill"
    assert snap["reserved_bytes.host"] == 0, "no reservation leaks"
    assert spilled.get("HashAggregateExec") and spilled.get("JoinExec"), spilled
    jax_tiny = _ctx("jax", budget=2048)
    for q, b, g in zip(QUERIES, base, got):
        pd.testing.assert_frame_equal(b.reset_index(drop=True), g.reset_index(drop=True))
        want = jax_tiny.sql(q).to_pandas()
        pd.testing.assert_frame_equal(g.reset_index(drop=True), want.reset_index(drop=True),
                                      check_dtype=False)


def test_spilled_inner_join_keeps_the_unspilled_order():
    base = _ctx("torch").sql(ORDER_SQL).to_pandas()
    tiny = _ctx("torch", budget=2048)
    got = tiny.sql(ORDER_SQL).to_pandas()
    assert _spill_metrics(tiny.last_plan).get("JoinExec"), "the join must have spilled"
    assert TK.LAUNCHES["spill_partition"] == 0, "no kernel launches on the CPU"
    pd.testing.assert_frame_equal(got, base)
    want = _ctx("jax", budget=2048).sql(ORDER_SQL).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


SPILLED_JOINS = {
    "semi": "select count(*) as n, sum(v) as s from t "
            "where exists (select 1 from d where d.g = t.g and d.w > 30)",
    "anti": "select count(*) as n, sum(v) as s from t "
            "where not exists (select 1 from d where d.g = t.g and d.w > 30)",
    "inner": "select t.g, t.v, d.name from t join d on t.g = d.g where d.w > 10",
}


@pytest.mark.parametrize("kind", list(SPILLED_JOINS))
def test_spilled_join_equals_its_unlimited_run(kind):
    """A spilled semi, anti and inner join (the build split by K16's
    ordered form, the verdicts by K7 with the probe mask folded in) equal
    their unlimited runs bit for bit, and the JAX package's spilled run."""
    sql = SPILLED_JOINS[kind]
    base = _ctx("torch").sql(sql).to_pandas()
    tiny = _ctx("torch", budget=2048)
    got = tiny.sql(sql).to_pandas()
    assert _spill_metrics(tiny.last_plan).get("JoinExec"), "the join must have spilled"
    pd.testing.assert_frame_equal(got, base)
    want = _ctx("jax", budget=2048).sql(sql).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_spill_disabled_denial_raises_retryable():
    c = TContext.local(TConfig({"ballista.shuffle.partitions": "2", MEM_HOST_BUDGET: "1024",
                                MEM_SPILL_ENABLED: "false"}), device="cpu")
    rng = np.random.default_rng(7)
    c.register_table("t", pa.table({
        "g": pa.array(rng.integers(0, 10, 4000).astype(np.int64)),
        "v": pa.array(rng.integers(0, 100, 4000).astype(np.int64))}))
    with pytest.raises(MemoryExhausted):
        c.sql("select g, sum(v) as s from t group by g order by g").to_pandas()


def test_standalone_executor_maps_a_denial_to_resource_exhausted():
    """With spill disabled, the executor reports the denial as a retryable
    RESOURCE_EXHAUSTED failure, not an execution error."""
    from arrow_ballista_tpu_torch.utils.errors import ExecutionError

    c = TContext.standalone(TConfig({"ballista.shuffle.partitions": "2",
                                     MEM_HOST_BUDGET: "1024", MEM_SPILL_ENABLED: "false"}),
                            concurrent_tasks=2, device="cpu")
    try:
        c.register_table("t", _tables()["t"])
        with pytest.raises(ExecutionError, match="memory exhausted"):
            c.sql("select g, sum(v) as s from t group by g order by g").to_pandas()
        ex = c._standalone.executors[0]
        assert ex.governor.reserved() == 0
    finally:
        c.shutdown()
