"""Query doctor: forensics bundles + rule-based pathology diagnosis.

``assemble_forensics`` collects everything the engine knows about one
job — journal timeline, per-stage runtime stats, device accounting,
profile/trace, AQE log, scheduler counters, cluster history — into one
self-contained JSON artifact (``ctx.forensics(job_id)`` on a standalone
session).

``diagnose`` runs a fixed rule catalog over a bundle and emits ranked,
evidence-cited findings.  Every rule is a pure predicate over bundle
fields with explicit thresholds; each finding carries the metric values
that triggered it and the config knob that remedies it.  The thresholds
are deliberately conservative: a clean single-query run (e.g. TPC-H q1 at
SF1) produces zero findings.

The port's copy of arrow_ballista_tpu/obs/doctor.py.  The catalog, its
thresholds and its finding texts are the reference's verbatim, so one
bundle diagnoses alike in both engines.  Rules whose evidence the port
cannot produce yet (speculation wins, quarantine, lease adoption, plan
caches, admission sheds) stay in the catalog and find nothing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

# --- rule thresholds -------------------------------------------------------
#: partition skew: max/mean per-partition rows at or above this, with at
#: least _SKEW_MIN_ROWS output rows over 2+ partitions
SKEW_COEFFICIENT_MIN = 2.0
_SKEW_MIN_ROWS = 5000
_SKEW_MIN_PARTITIONS = 2
#: straggler: p95/p50 completed-task duration spread at or above this
#: with the slowest task at least _STRAGGLER_MIN_MAX_S — or any
#: speculation win recorded for the stage
STRAGGLER_SPREAD_MIN = 3.0
_STRAGGLER_MIN_MAX_S = 0.5
#: ... unless the stage's compile time (in the port: nvcc builds of
#: generated sources) accounts for this fraction of the slowest task: a
#: fresh process's first task pays the cold build, and speculation can't
#: outrun a compiler — that spread is warm-up, not a straggler
_STRAGGLER_COMPILE_FRACTION = 0.5
#: retrace storm: stage-level jit_retraces at or above this AND at least
#: this multiple of jit_compiles (shape churn, not first-compile cost)
RETRACE_STORM_MIN = 12
RETRACE_COMPILE_RATIO = 3.0
#: shuffle hotspot: max/mean per-partition shuffle bytes at or above
#: this with at least _HOTSPOT_MIN_BYTES written
HOTSPOT_IMBALANCE_MIN = 4.0
_HOTSPOT_MIN_BYTES = 1 << 20
#: cache churn: this many plan-cache misses with a hit rate under 50%
CACHE_MISS_MIN = 8
CACHE_HIT_RATE_MAX = 0.5
#: control-plane churn: mean event-loop lag at or above this, or any
#: lease adoption / quarantine recorded in the job's journal
LAG_MEAN_MIN_S = 0.05
LAG_MAX_MIN_S = 0.25
#: memory pressure: any spill run means the governor denied an in-memory
#: grant and an operator degraded to disk — correct but slower, so the
#: doctor points at the budget knob.  A clean unbudgeted run never spills.
MEMORY_SPILL_MIN_RUNS = 1
#: fusion missed: the whole-stage compiler REJECTED a chain whose
#: downstream operators still paid at least this much measured
#: transfer/compile dispatch (the advisor's savings estimate, ms) — a
#: clean small query stays far under it, so the rule only fires when the
#: interpreter tax was real
FUSION_MISSED_MIN_SAVINGS_MS = 50.0


def assemble_forensics(server, job_id: str) -> Optional[Dict]:
    """One self-contained forensics artifact for ``job_id`` off a live
    SchedulerServer.  Returns None for an unknown job.  The port's
    scheduler keeps its counters in a plain dict (``server.counters``)."""
    from . import journal
    from .stats import stage_summary

    status = server.jobs.get_status(job_id)
    if status is None:
        return None
    graph = server.jobs.get_graph(job_id)
    timeline = journal.job_timeline(job_id)
    if not timeline and graph is not None:
        # adopted/recovered graph whose in-memory journal aged out: the
        # checkpointed copy is the record
        timeline = list(getattr(graph, "journal", []) or [])
    stages: List[Dict] = []
    aqe_log: List[Dict] = []
    if graph is not None:
        stages = [stage_summary(graph.stages[sid])
                  for sid in sorted(graph.stages)]
        aqe_log = [dict(r) for r in getattr(graph, "aqe_log", [])]
    try:
        profile = server.obs.get_profile(job_id, graph, status)
    except Exception:  # noqa: BLE001 — profile retention is best-effort
        profile = None
    try:
        trace = server.obs.get_trace(job_id, graph)
    except Exception:  # noqa: BLE001
        trace = None
    counters = dict(getattr(server, "counters", None) or {})
    history = server.cluster_history() \
        if hasattr(server, "cluster_history") else {}
    return {
        "schema": "ballista.forensics/v1",
        "job_id": job_id,
        "generated_ts_ms": int(time.time() * 1000),
        "scheduler_id": getattr(server, "scheduler_id", ""),
        "status": {"state": status.state, "error": status.error},
        "journal": timeline,
        "journal_enabled": journal.enabled(),
        "stages": stages,
        "aqe_log": aqe_log,
        "profile": profile,
        "trace": trace,
        "metrics": counters,
        "cluster_history": history,
    }


def validate_bundle(bundle: Dict) -> List[str]:
    """Schema check for the forensics artifact (CI doctor smoke stage).
    Returns a list of problems; empty = valid."""
    problems: List[str] = []
    if bundle.get("schema") != "ballista.forensics/v1":
        problems.append(f"unknown schema {bundle.get('schema')!r}")
    for key, typ in (("job_id", str), ("generated_ts_ms", int),
                     ("status", dict), ("journal", list), ("stages", list),
                     ("aqe_log", list), ("metrics", dict),
                     ("cluster_history", dict)):
        if not isinstance(bundle.get(key), typ):
            problems.append(f"field {key!r} missing or not {typ.__name__}")
    for i, ev in enumerate(bundle.get("journal") or []):
        if not isinstance(ev, dict) or "seq" not in ev or "kind" not in ev:
            problems.append(f"journal[{i}] lacks seq/kind")
            break
    for i, st in enumerate(bundle.get("stages") or []):
        if not isinstance(st, dict) or "stage_id" not in st:
            problems.append(f"stages[{i}] lacks stage_id")
            break
    return problems


# --------------------------------------------------------------------------
# rule catalog
# --------------------------------------------------------------------------

def _stage_findings(bundle: Dict) -> List[Dict]:
    out: List[Dict] = []
    for st in bundle.get("stages") or []:
        sid = st.get("stage_id", 0)
        rows = int(st.get("output_rows", 0) or 0)
        parts = int(st.get("tasks_completed", 0) or 0)
        dur = st.get("task_duration_s") or {}
        # -- partition skew ------------------------------------------------
        skew = float(st.get("skew", 0.0) or 0.0)
        if skew >= SKEW_COEFFICIENT_MIN and rows >= _SKEW_MIN_ROWS \
                and parts >= _SKEW_MIN_PARTITIONS:
            prows = {int(k): int(v)
                     for k, v in (st.get("partition_rows") or {}).items()}
            hot = max(prows, key=prows.get) if prows else -1
            out.append({
                "rule": "partition-skew",
                "severity": round(skew * max(dur.get("max", 0.0), 1.0), 3),
                "stage_id": sid,
                "summary": f"stage {sid}: hottest partition carries "
                           f"{skew:.1f}x its fair share of "
                           f"{rows:,} rows",
                "evidence": {"skew_coefficient": skew, "output_rows": rows,
                             "hot_partition": hot,
                             "hot_partition_rows": prows.get(hot, 0),
                             "task_duration_s": dur},
                "remedy": "enable ballista.aqe.enabled with "
                          "ballista.aqe.skew.factor to split hot "
                          "partitions, or repartition on a higher-"
                          "cardinality key",
            })
        # -- straggler-dominated stage ------------------------------------
        spread = (dur.get("p95", 0.0) / dur.get("p50", 0.0)) \
            if dur.get("p50") else 0.0
        spec_wins = _journal_count(bundle, "speculation.win", stage_id=sid)
        compile_s = float((st.get("device") or {})
                          .get("jit_compile_time", 0.0) or 0.0)
        cold_compile = not spec_wins and dur.get("max", 0.0) > 0 \
            and compile_s >= _STRAGGLER_COMPILE_FRACTION * dur["max"]
        if ((dur.get("count", 0) >= 2 and spread >= STRAGGLER_SPREAD_MIN
                and dur.get("max", 0.0) >= _STRAGGLER_MIN_MAX_S
                and not cold_compile)
                or spec_wins):
            out.append({
                "rule": "straggler",
                "severity": round(max(spread, 1.0)
                                  * max(dur.get("max", 0.0), 0.1)
                                  + 2.0 * spec_wins, 3),
                "stage_id": sid,
                "summary": f"stage {sid}: task durations spread "
                           f"p95/p50={spread:.1f}x"
                           + (f", {spec_wins} speculative win(s)"
                              if spec_wins else ""),
                "evidence": {"task_duration_s": dur,
                             "duration_spread_p95_p50": round(spread, 3),
                             "speculative_launches":
                                 st.get("speculative_launches", 0),
                             "speculation_wins": spec_wins},
                "remedy": "enable/tune ballista.speculation.enabled, "
                          "ballista.speculation.quantile and "
                          "ballista.speculation.multiplier; check the "
                          "straggling executor's journal events",
            })
        # -- retrace storm -------------------------------------------------
        dev = st.get("device") or {}
        retraces = int(dev.get("jit_retraces", 0) or 0)
        compiles = int(dev.get("jit_compiles", 0) or 0)
        if retraces >= RETRACE_STORM_MIN \
                and retraces >= RETRACE_COMPILE_RATIO * max(compiles, 1):
            hot_op = _hot_retrace_operator(st)
            out.append({
                "rule": "retrace-storm",
                "severity": round(retraces / max(compiles, 1), 3),
                "stage_id": sid,
                "summary": f"stage {sid}: {retraces} JIT retraces vs "
                           f"{compiles} compiles — shape/static-arg churn "
                           "is recompiling the same operators",
                "evidence": {"jit_retraces": retraces,
                             "jit_compiles": compiles,
                             "jit_compile_time_s":
                                 dev.get("jit_compile_time", 0.0),
                             "hottest_operator": hot_op},
                "remedy": "stabilize batch shapes (ballista.batch.size) "
                          "or fuse the chain (stage-fusion advisor, "
                          "ROADMAP item 2: /api/job/<id>/advise)",
            })
        # -- fusion missed -------------------------------------------------
        # a fused=False record means the compiler considered the chain and
        # left it interpreted; charge the measured host-side dispatch of
        # the non-head operators that WOULD have been inside the kernel
        # (fusable classes only — the scan feeding the chain keeps its
        # transfer cost either way)
        from ..compile.fuse import DEFAULT_OPERATORS as _fusable_classes
        opm = st.get("operators") or {}
        for rec in st.get("fusion") or []:
            if rec.get("fused"):
                continue
            saved = 0.0
            for path, op in zip((rec.get("paths") or [])[1:],
                                (rec.get("operators") or [])[1:]):
                if op not in _fusable_classes:
                    continue
                mm = opm.get(f"{path}:{op}") or {}
                # transfer dispatch + the RETRACE share of compile time:
                # the first compile is paid once either way (a fused
                # kernel compiles too), so cold-start cost never counts
                compiles = int(mm.get("jit_compiles", 0) or 0)
                retraces = int(mm.get("jit_retraces", 0) or 0)
                events = compiles + retraces
                retrace_s = (float(mm.get("jit_compile_time", 0.0) or 0.0)
                             * retraces / events) if events else 0.0
                saved += (float(mm.get("h2d_time", 0.0) or 0.0)
                          + float(mm.get("d2h_time", 0.0) or 0.0)
                          + retrace_s) * 1000.0
            if saved < FUSION_MISSED_MIN_SAVINGS_MS:
                continue
            reasons = [f"{r.get('op')}: {r.get('reason')}"
                       for r in rec.get("rejected") or []]
            out.append({
                "rule": "fusion-missed",
                "severity": round(saved / 100.0, 3),
                "stage_id": sid,
                "summary": f"stage {sid}: chain "
                           + " -> ".join(rec.get("operators") or [])
                           + f" ran interpreted — ~{saved:.0f} ms of "
                             "inter-operator dispatch one fused kernel "
                             "would not pay",
                "evidence": {"est_savings_ms": round(saved, 3),
                             "rejected": reasons,
                             "chain": list(rec.get("operators") or [])},
                "remedy": "address the rejection reasons (see evidence), "
                          "or widen ballista.compile.operators / lower "
                          "ballista.compile.min.ops; compare fused=true "
                          "chains in /api/job/<id>/advise",
            })
        # -- memory pressure (spill-to-disk) -------------------------------
        spill_runs = int(st.get("spill_runs", 0) or 0)
        spill_bytes = int(st.get("spill_bytes", 0) or 0)
        if spill_runs >= MEMORY_SPILL_MIN_RUNS:
            out.append({
                "rule": "memory-pressure",
                "severity": round(spill_bytes / float(1 << 20), 3),
                "stage_id": sid,
                "summary": f"stage {sid}: operators spilled "
                           f"{spill_bytes:,} bytes to disk over "
                           f"{spill_runs} run(s) — the memory governor "
                           "denied in-memory grants",
                "evidence": {"spill_bytes": spill_bytes,
                             "spill_runs": spill_runs,
                             "spilled_operators":
                                 sorted(name for name, mm in
                                        (st.get("operators") or {}).items()
                                        if int((mm or {})
                                               .get("spill_runs", 0) or 0))},
                "remedy": "raise ballista.memory.host.budget.bytes (or "
                          ".device.) if the host has headroom; otherwise "
                          "the spill is the correct degradation — reduce "
                          "build-side/group cardinality or add executors",
            })
        # -- shuffle hotspot -----------------------------------------------
        pbytes = [int(v) for v in (st.get("partition_bytes") or {}).values()]
        total_bytes = sum(pbytes)
        if pbytes and total_bytes >= _HOTSPOT_MIN_BYTES:
            imbalance = max(pbytes) / (total_bytes / len(pbytes))
            if imbalance >= HOTSPOT_IMBALANCE_MIN:
                out.append({
                    "rule": "shuffle-hotspot",
                    "severity": round(imbalance, 3),
                    "stage_id": sid,
                    "summary": f"stage {sid}: one shuffle partition holds "
                               f"{max(pbytes):,} of {total_bytes:,} bytes "
                               f"({imbalance:.1f}x its fair share)",
                    "evidence": {"bytes_imbalance": round(imbalance, 3),
                                 "max_partition_bytes": max(pbytes),
                                 "total_bytes": total_bytes,
                                 "partitions": len(pbytes)},
                    "remedy": "raise ballista.shuffle.partitions or enable "
                              "ballista.aqe.enabled (coalesce+skew-split); "
                              "co-locate hot consumers "
                              "(ballista.shuffle.local.host_match)",
                })
    return out


def _hot_retrace_operator(stage: Dict) -> str:
    hot, hot_n = "", 0
    for name, ms in (stage.get("operators") or {}).items():
        n = int((ms or {}).get("jit_retraces", 0) or 0)
        if n > hot_n:
            hot, hot_n = name, n
    return hot


def _journal_count(bundle: Dict, kind: str, stage_id: Optional[int] = None,
                   ) -> int:
    n = 0
    for ev in bundle.get("journal") or []:
        if ev.get("kind") != kind:
            continue
        if stage_id is not None \
                and (ev.get("attrs") or {}).get("stage_id") != stage_id:
            continue
        n += 1
    return n


def _global_findings(bundle: Dict) -> List[Dict]:
    out: List[Dict] = []
    # -- cache-miss churn --------------------------------------------------
    m = bundle.get("metrics") or {}
    hits = int(m.get("plan_cache_hits", 0) or 0)
    misses = int(m.get("plan_cache_misses", 0) or 0)
    looked = hits + misses
    if misses >= CACHE_MISS_MIN \
            and (hits / looked if looked else 0.0) < CACHE_HIT_RATE_MAX:
        out.append({
            "rule": "cache-miss-churn",
            "severity": round(misses / max(hits, 1), 3),
            "summary": f"plan cache churning: {misses} misses vs {hits} "
                       "hits — repeated statements are re-planning",
            "evidence": {"plan_cache_hits": hits,
                         "plan_cache_misses": misses,
                         "result_cache_hits":
                             int(m.get("result_cache_hits", 0) or 0),
                         "cache_evictions":
                             int(m.get("cache_evictions", 0) or 0)},
            "remedy": "raise ballista.plan.cache.max.entries / "
                      "ballista.result.cache.max.bytes, or parameterize "
                      "statements so templates actually repeat",
        })
    # -- cluster-wide memory shed -------------------------------------------
    sheds = int(m.get("memory_pressure_sheds_total", 0) or 0)
    if sheds:
        out.append({
            "rule": "memory-pressure",
            "severity": round(float(sheds), 3),
            "summary": f"admission shed/deferred {sheds} job(s) because "
                       "every alive executor's memory pressure crossed "
                       "the shed threshold",
            "evidence": {"memory_pressure_sheds_total": sheds},
            "remedy": "add executors or raise per-executor "
                      "ballista.memory.*.budget.bytes; clients saw a "
                      "retriable ResourceExhausted and should back off "
                      "and resubmit",
        })
    # -- poison-suspect ------------------------------------------------------
    for ev in bundle.get("journal") or []:
        if ev.get("kind") != "job.poisoned":
            continue
        attrs = ev.get("attrs") or {}
        evidence = attrs.get("evidence") or {}
        executors = sorted({eid for per in evidence.values()
                            for eid in per}) \
            if isinstance(evidence, dict) else []
        partitions = sorted(evidence) if isinstance(evidence, dict) else []
        out.append({
            "rule": "poison-suspect",
            "severity": round(float(len(executors) or 1), 3),
            "summary": "job classified poison: the same partition failed "
                       f"with equivalent errors on {len(executors)} "
                       "distinct executor(s) "
                       f"({', '.join(executors) or 'unknown'}) — the "
                       "query, not the fleet, is the culprit",
            "evidence": {"distinct_executors": len(executors),
                         "executors": executors,
                         "partitions": partitions,
                         "per_executor_errors": evidence},
            "remedy": "inspect the per-executor error signatures above "
                      "(bad input split, overflow, pathological plan); "
                      "fix the query/data before resubmitting — retries "
                      "were abandoned on purpose and no executor was "
                      "quarantined",
        })
        break  # one containment verdict per job
    # -- control-plane churn -----------------------------------------------
    samples = (bundle.get("cluster_history") or {}).get("samples") or []
    lags = [float(s.get("event_loop_lag_s", 0.0) or 0.0) for s in samples]
    mean_lag = sum(lags) / len(lags) if lags else 0.0
    max_lag = max(lags) if lags else 0.0
    adoptions = _journal_count(bundle, "lease.adopt")
    quarantines = _journal_count(bundle, "quarantine.enter")
    if mean_lag >= LAG_MEAN_MIN_S or max_lag >= LAG_MAX_MIN_S \
            or adoptions or quarantines:
        out.append({
            "rule": "control-plane-churn",
            "severity": round(10.0 * mean_lag + adoptions + quarantines, 3),
            "summary": "control plane churned during this job: "
                       f"{adoptions} lease adoption(s), {quarantines} "
                       f"quarantine(s), event-loop lag mean "
                       f"{mean_lag * 1000:.0f} ms / max "
                       f"{max_lag * 1000:.0f} ms",
            "evidence": {"lease_adoptions": adoptions,
                         "quarantines": quarantines,
                         "event_loop_lag_mean_s": round(mean_lag, 4),
                         "event_loop_lag_max_s": round(max_lag, 4),
                         "history_samples": len(samples)},
            "remedy": "inspect journal lease/quarantine events for the "
                      "failing component; tune ballista.fleet.lease.ttl."
                      "seconds / ballista.scheduler.quarantine.failures; "
                      "shard hot tenants across the fleet",
        })
    return out


def diagnose(bundle: Dict) -> Dict:
    """Run the rule catalog over one forensics bundle.  Pure and
    deterministic: equal bundles produce equal, severity-ranked output."""
    findings = _stage_findings(bundle) + _global_findings(bundle)
    findings.sort(key=lambda f: (-f["severity"], f["rule"],
                                 f.get("stage_id", -1)))
    out = {
        "job_id": bundle.get("job_id", ""),
        "state": (bundle.get("status") or {}).get("state", ""),
        "findings": findings,
        "rules_evaluated": ["partition-skew", "straggler", "retrace-storm",
                            "fusion-missed", "memory-pressure",
                            "shuffle-hotspot", "cache-miss-churn",
                            "control-plane-churn", "poison-suspect"],
    }
    out["text"] = render_diagnosis(out)
    return out


def render_diagnosis(diag: Dict) -> str:
    lines = [f"== QUERY DOCTOR: job {diag['job_id']} "
             f"[{diag.get('state', '')}] — "
             f"{len(diag['findings'])} finding(s) =="]
    if not diag["findings"]:
        lines.append("no pathology detected "
                     f"({len(diag.get('rules_evaluated', []))} rules "
                     "evaluated clean)")
    for i, f in enumerate(diag["findings"], 1):
        where = f" (stage {f['stage_id']})" if "stage_id" in f else ""
        lines.append(f"{i}. [{f['rule']}]{where} severity "
                     f"{f['severity']:.1f}")
        lines.append(f"   {f['summary']}")
        ev = " · ".join(f"{k}={v}" for k, v in sorted(f["evidence"].items())
                        if not isinstance(v, (dict, list)))
        if ev:
            lines.append(f"   evidence: {ev}")
        lines.append(f"   remedy: {f['remedy']}")
    return "\n".join(lines)
