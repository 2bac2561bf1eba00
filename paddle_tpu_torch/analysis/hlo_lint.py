"""Cost-tier lint rules over a :class:`~paddle_tpu_torch.analysis.
cost_model.CostReport`, plus the bucket-coverage proof for the serving
engines (``paddle_tpu/analysis/hlo_lint.py``; the name kept so a reader
finds the counterpart, though the port's third tier reads a traced aten
graph, not HLO).

The third tier of the static-analysis stack (AST -> graph -> cost): these
rules fire on hazards visible in the whole traced program --

- **unexpected-collective** -- collectives outside a declared allowlist.
  A single-card serving decode/prefill step must contain zero; on a
  tensor-parallel mesh only the planned kinds (the tp all-reduce after
  the sharded attention) are acceptable.
- **resharding-churn** -- a large value gathered to full size and
  scattered again with no arithmetic in between (found by the cost
  walker).
- **peak-hbm-budget** -- the liveness-based peak-memory estimate exceeds
  the declared budget.
- **flops budget** (reported as ``cost-regression``) -- static flops
  exceed the declared budget.
- **bucket-coverage** -- the ahead-of-time half of the zero-capture
  invariant: enumerate every pow2 bucket signature the engine's
  steady-state loop can request and prove ``warmup()``'s capture plan
  covers it. The reachable set comes from the *step-side* bucketing
  functions and the warmed set from the *warmup-side* plan -- two
  independent derivations, so a drift in either fires the rule before
  the first capture mid-serving.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.analysis.findings import RULES, Finding


def _mb(n: int) -> str:
    return f"{n / (1 << 20):.2f}MiB"


def lint_cost_report(cost, *,
                     collective_allowlist: Optional[Sequence[str]] = None,
                     hbm_budget_bytes: Optional[int] = None,
                     flops_budget: Optional[int] = None) -> List[Finding]:
    """Findings for one :class:`CostReport`.

    ``collective_allowlist``: ``None`` skips the collective check
    entirely; a sequence (possibly empty — the single-device serving
    contract) permits exactly those kinds. ``hbm_budget_bytes`` /
    ``flops_budget``: ``None`` skips that budget."""
    findings: List[Finding] = []
    if collective_allowlist is not None:
        allowed = set(collective_allowlist)
        for kind, nbytes in sorted(cost.collective_kinds().items()):
            if kind in allowed:
                continue
            sites = [c for c in cost.collectives if c.kind == kind]
            ax = sorted({c.axis for c in sites if c.axis})
            findings.append(Finding(
                "unexpected-collective", RULES["unexpected-collective"][0],
                f"{len(sites)} `{kind}` op(s) moving {_mb(nbytes)} "
                f"{'over axis ' + '/'.join(ax) + ' ' if ax else ''}"
                f"in the lowered program, outside the allowlist "
                f"{sorted(allowed) or '(none)'}",
                location=sites[0].location,
                fix="remove the collective from the step, or declare it "
                    "in the surface's allowlist if the comm is intended",
                engine="hlo"))
    for site in cost.resharding:
        findings.append(Finding(
            "resharding-churn", RULES["resharding-churn"][0],
            f"a {_mb(site.bytes)} value goes {site.src} -> {site.dst} "
            "with no arithmetic in between: it crosses the wire twice "
            "to end where it began, every step",
            location=site.location,
            fix="keep the value in its sharded layout (drop the gather "
                "and the scatter), or compute on it while it is whole",
            engine="hlo"))
    if hbm_budget_bytes is not None and \
            cost.peak_hbm_bytes > hbm_budget_bytes:
        findings.append(Finding(
            "peak-hbm-budget", RULES["peak-hbm-budget"][0],
            f"static peak-HBM estimate {_mb(cost.peak_hbm_bytes)} "
            f"exceeds the declared budget {_mb(hbm_budget_bytes)}",
            location=cost.name,
            fix="write large state in place (cuts old+new copies), shrink "
                "the surface, or raise the committed budget with a "
                "rationale",
            engine="hlo"))
    if flops_budget is not None and cost.total_flops > flops_budget:
        findings.append(Finding(
            "cost-regression", RULES["cost-regression"][0],
            f"static flops {cost.total_flops:,} exceed the declared "
            f"budget {flops_budget:,}",
            location=cost.name,
            fix="profile what grew (CostReport.per_op names the op), or "
                "raise the committed budget with a rationale",
            engine="hlo"))
    return findings


# ---------------------------------------------------------------------------
# bucket coverage: reachable signatures vs the warmup plan
# ---------------------------------------------------------------------------

def _coverage_findings(reachable: Set[Tuple], warmed: Set[Tuple],
                       name: str, engine_kind: str) -> List[Finding]:
    findings = []
    for sig in sorted(reachable - warmed, key=str):
        findings.append(Finding(
            "bucket-coverage", RULES["bucket-coverage"][0],
            f"{engine_kind} bucket signature {sig} is statically "
            "reachable by the steady-state loop but missing from "
            "warmup's capture plan: the first request hitting it "
            "captures a graph mid-serving",
            location=f"{name}:{sig}",
            fix="align warmup()'s bucket enumeration with the step-side "
                "bucketing (warmup_plan() must cover every reachable "
                "signature)",
            engine="hlo"))
    return findings


def serving_bucket_coverage(engine, warmed: Optional[Set[Tuple]] = None,
                            name: str = "serving") -> List[Finding]:
    """Prove ``ServingEngine.warmup()`` captures every decode/prefill
    signature ``step()`` can request.

    Reachable signatures are enumerated from the *step-side* bucketing
    (``_pow2_width`` over every live page count, ``_pow2_count`` over
    every in-prefill slot count); the warmed set defaults to the
    *warmup-side* :meth:`ServingEngine.warmup_plan`. Pass ``warmed``
    explicitly to audit a doctored or partial warmup (the tests do)."""
    if warmed is None:
        warmed = set(engine.warmup_plan())
    return _coverage_findings(set(engine.reachable_signatures()),
                              set(warmed), name, "serving")


def embedding_bucket_coverage(cache, max_uniq: int,
                              warmed: Optional[Set[Tuple]] = None,
                              name: str = "embedding"
                              ) -> List[Finding]:
    """Prove ``DeviceEmbeddingCache.warmup(max_uniq)`` captures every
    gather/install width a batch with up to ``max_uniq`` unique ids can
    request (same two-sided derivation as the serving variant)."""
    if warmed is None:
        warmed = set(cache.warmup_plan(max_uniq))
    return _coverage_findings(set(cache.reachable_buckets(max_uniq)),
                              set(warmed), name, "embedding")


def check_bucket_coverage(engine, *, max_uniq: Optional[int] = None,
                          warmed: Optional[Set[Tuple]] = None,
                          name: Optional[str] = None) -> List[Finding]:
    """Dispatch on engine type: a token-serving engine (has
    ``reachable_signatures``) or an embedding cache/engine (needs
    ``max_uniq``)."""
    if hasattr(engine, "reachable_signatures"):
        return serving_bucket_coverage(engine, warmed,
                                       name or "serving")
    cache = getattr(engine, "cache", engine)
    if max_uniq is None:
        raise ValueError("embedding coverage needs max_uniq (the "
                         "warmup's per-batch unique-id bound)")
    return embedding_bucket_coverage(cache, max_uniq, warmed,
                                     name or "embedding")
