"""Finding records, reports and suppressions: the lint reporting spine
(``paddle_tpu/analysis/findings.py``).

Every analysis pass of the port (the AST, graph and cost tiers, the
kernel-registry lint, the concurrency lint and sanitizer, the
conformance lints) emits :class:`Finding` records into one
:class:`Report`; the report renders as text or JSON (with the static
:class:`~paddle_tpu_torch.analysis.cost_model.CostReport` a cost lint
attaches), counts findings into the observability registry
(``analysis_findings_total{rule,severity}``), and applies a
:class:`Suppressions` file so known-accepted warnings do not fail a run.
:data:`RULES` holds the rules the port's passes emit, each with the
reference's id and severity.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

SEVERITIES = ("info", "warning", "error")

#: the port's committed suppressions (each entry with its reason)
SUPPRESSIONS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "suppressions.txt")

#: rule id -> (severity, one-line description): every rule the port's
#: passes can emit
RULES = {
    "host-callback": (
        "error",
        "the traced step returns to the host mid-step (.item()/a scalar "
        "read, a device-to-CPU copy, a data-dependent shape such as "
        "nonzero or boolean-mask indexing): a sync on the hot path that "
        "also breaks CUDA graph capture"),
    "debug-callback": (
        "warning",
        "a device-side assert or print-style host hook in the traced "
        "step: fine for debugging, a host sync in production"),
    "f64-promotion": (
        "warning",
        "float64/complex128 values in the traced step: the card runs "
        "fp64 at a fraction of its fp32 rate and bf16/fp32 kernels do "
        "not take it; usually an accidental numpy/Python-float promotion"),
    "undonated-buffer": (
        "warning",
        "a large state input's same-shape, same-dtype successor is a new "
        "tensor returned in its place instead of being written into it "
        "in place: peak memory holds the old and new copy"),
    "prng-key-reuse": (
        "error",
        "a random op draws from a generator the step creates or re-seeds "
        "with a constant inside its body (or, in a captured step, one the "
        "CUDA graph does not register): every step draws the same bits"),
    "replicated-large": (
        "warning",
        "large tensor replicated on every rank under the given sharding "
        "plan: its memory is multiplied by the mesh size"),
    "ast-host-sync": (
        "warning",
        "host-sync Python call (.item()/.tolist()/.cpu()/.numpy()/"
        "float()/np.asarray/torch.cuda.synchronize()/time.time()/stdlib "
        "random) inside the step"),
    "ast-tracer-branch": (
        "error",
        "Python if/while on a tensor value inside the step: a host sync "
        "per call, and in a CUDA-graphed step the branch taken at "
        "capture is frozen into every replay"),
    "unexpected-collective": (
        "error",
        "a collective (all-reduce/all-gather/...) in the traced step "
        "outside the declared allowlist: an implicit cross-rank sync on "
        "every step (single-card serving steps must have zero)"),
    "resharding-churn": (
        "warning",
        "a large value is gathered to full size and scattered again "
        "with no arithmetic in between: a round trip over the wire on "
        "every step"),
    "peak-hbm-budget": (
        "error",
        "the traced step's static peak-memory estimate exceeds the "
        "declared budget: the step may run out of device memory on the "
        "card the budget was sized for"),
    "bucket-coverage": (
        "error",
        "a statically reachable pow2 bucket signature is missing from "
        "warmup's capture plan: the first request hitting it captures "
        "a graph mid-serving (breaks the zero-capture invariant)"),
    "cost-regression": (
        "error",
        "a static cost metric (flops / peak memory / collective bytes) "
        "regressed beyond tolerance vs the committed baseline "
        "(paddle_tpu_torch/analysis/cost_budgets.json)"),
    "kernel-contract": (
        "error",
        "a registered kernel's declared contract (layouts, tunables and "
        "their candidates, shared memory, the C entry points' arity) "
        "disagrees with what its sample inputs, its implementations or "
        "csrc/ actually give (paddle_tpu_torch/kernels/lint.py)"),
    "kernel-registry-bypass": (
        "error",
        "a csrc/ entry point that no registered kernel (or more than one) "
        "names, or a ctypes binding outside the registered home modules, "
        "not allowlisted in paddle_tpu_torch/kernels/lint.py: bespoke "
        "kernels bypass the shared autotuner, parity battery and launch "
        "counts"),
    "unguarded-access": (
        "error",
        "a @guarded_by field is read or written outside a `with "
        "self.<lock>:` scope (one level of intra-class call "
        "propagation): a data race once a second thread exists"),
    "lock-order-cycle": (
        "error",
        "the static lock-acquisition graph has a cycle: two threads "
        "taking the locks in opposite order deadlock"),
    "double-acquire": (
        "error",
        "a non-reentrant threading.Lock is acquired on a path that "
        "already holds it: guaranteed same-thread deadlock"),
    "lock-order-drift": (
        "error",
        "the extracted lock universe / acquisition edges differ from "
        "the committed paddle_tpu_torch/analysis/lock_order.json "
        "(missing, orphaned, or stale entries): regenerate with "
        "--update-lock-order and review the order"),
    "sanitizer-violation": (
        "error",
        "the runtime lock sanitizer observed an acquisition order "
        "between statically-ordered locks that the committed graph "
        "does not bless: an inversion or a statically invisible path"),
    "interface-drift": (
        "error",
        "a ReplicaHandle implementation or the wire dispatch table "
        "drifted from the handle protocol (missing method, signature "
        "mismatch, or unmapped wire op): a new handle method missing "
        "from the dispatch is a CI failure, not a runtime RemoteError"),
    "reject-vocab-drift": (
        "error",
        "a Reject(...) construction uses a reason literal outside "
        "scheduler.REJECT_REASONS, or a registry entry is constructed "
        "nowhere: the vocabulary has a single source of truth"),
}


@dataclasses.dataclass
class Finding:
    """One diagnostic: what rule fired, where, and how to fix it."""

    rule: str                 # key into RULES
    severity: str             # info|warning|error
    message: str              # specific to this site
    location: str = ""        # "node[3] aten.nonzero" or "file.py:42"
    fix: str = ""             # actionable hint
    engine: str = "plan"      # fx | ast | plan | cost | concurrency

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        hint = f"\n      fix: {self.fix}" if self.fix else ""
        return (f"  [{self.severity.upper():7s}] {self.rule}{loc}\n"
                f"      {self.message}{hint}")


class Suppressions:
    """Committed allow-list of known-accepted findings.

    File format, one entry per line::

        # comment
        <rule-id>  <substring matched against "name location message">

    A ``*`` substring (or none) suppresses every site of the rule.
    """

    def __init__(self, entries: Sequence[Tuple[str, str]] = ()):
        self.entries = list(entries)
        self.used: set = set()      # entry indices that matched a finding

    @classmethod
    def load(cls, path: str) -> "Suppressions":
        entries = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 1)
                rule = parts[0]
                pat = parts[1].strip() if len(parts) > 1 else "*"
                entries.append((rule, pat))
        return cls(entries)

    def matches(self, context: str, finding: Finding) -> bool:
        hay = f"{context} {finding.location} {finding.message}"
        for i, (rule, pat) in enumerate(self.entries):
            if rule == finding.rule and (pat == "*" or pat in hay):
                self.used.add(i)
                return True
        return False

    def stale(self) -> List[Tuple[str, str]]:
        """Entries that matched nothing since construction. Run the whole
        lint surface first: a suppression that no longer fires is dead
        weight that would silently re-accept a future regression."""
        return [e for i, e in enumerate(self.entries) if i not in self.used]


class Report:
    """Findings for one linted function, with rendering + registry hooks."""

    def __init__(self, name: str = "fn",
                 findings: Iterable[Finding] = (),
                 suppressions: Optional[Suppressions] = None):
        self.name = name
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self._suppressions = suppressions
        #: attached by ``lint_fn(cost=True)``: the static
        #: :class:`~paddle_tpu_torch.analysis.cost_model.CostReport`
        self.cost = None
        for f in findings:
            self.add(f)

    def add(self, finding: Finding):
        if self._suppressions is not None and \
                self._suppressions.matches(self.name, finding):
            self.suppressed.append(finding)
        else:
            self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]):
        for f in findings:
            self.add(f)

    # -- queries ------------------------------------------------------------
    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    def ok(self, fail_on: str = "error") -> bool:
        """True when no finding is at/above ``fail_on`` severity."""
        bad = SEVERITIES[SEVERITIES.index(fail_on):]
        return not any(f.severity in bad for f in self.findings)

    def __len__(self):
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    # -- rendering ----------------------------------------------------------
    def render_text(self) -> str:
        lines = [f"graph lint: {self.name} — {len(self.findings)} finding"
                 f"{'s' if len(self.findings) != 1 else ''}"
                 + (f" ({len(self.suppressed)} suppressed)"
                    if self.suppressed else "")]
        order = {s: i for i, s in enumerate(reversed(SEVERITIES))}
        for f in sorted(self.findings, key=lambda f: order[f.severity]):
            lines.append(f.render())
        if self.cost is not None:
            lines.append("  " + self.cost.render_text().splitlines()[0])
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
            **({"cost": self.cost.as_dict()}
               if self.cost is not None else {}),
        }, indent=1)

    # -- observability ------------------------------------------------------
    def count_into_registry(self, reg=None):
        """One ``analysis_findings_total{rule,severity}`` bump per finding
        (+ an ``analysis_lint_runs_total`` bump per report)."""
        from paddle_tpu_torch import observability
        reg = reg or observability.default()
        reg.counter("analysis_lint_runs_total",
                    "static-analysis reports produced").inc()
        for f in self.findings:
            reg.counter("analysis_findings_total",
                        "static-analysis findings by rule/severity").inc(
                            rule=f.rule, severity=f.severity)
        return self
