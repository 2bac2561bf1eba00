"""Finding records, reports and suppressions: the lint reporting spine
(``paddle_tpu/analysis/findings.py``).

Every analysis pass of the port (the kernel-registry lint, the
concurrency lint and sanitizer, the conformance lints) emits
:class:`Finding` records into one :class:`Report`; the report renders
as text or JSON, counts findings into the observability registry
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
    location: str = ""        # "kernels/<name>" or "file.py:42"
    fix: str = ""             # actionable hint
    engine: str = "plan"      # ast | plan | concurrency

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
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
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
