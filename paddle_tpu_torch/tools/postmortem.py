"""Render flight-recorder postmortem bundles for human eyes.

The router dumps a bundle (``observability.flight.write_bundle``) on a
replica eject, a breaker opening or a shed spike; this tool is the
offline half. Point it at one bundle or a dump directory: it validates
the schema, then prints the incident digest (who died, why, which
requests were on board by trace id, the health trajectory up to the
failure, the step-anatomy tail, the headroom at capture).
``--trace-out`` extracts the embedded Chrome trace for Perfetto.

Usage:
    python -m paddle_tpu_torch.tools.postmortem BUNDLE.json \
        [--trace-out trace.json]
    python -m paddle_tpu_torch.tools.postmortem DUMP_DIR/ [--tail N]

Exit 0 when every bundle validates; exit 1 with a precise message
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _fmt_ts(ts: float) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ts)) + "Z"
    except (OverflowError, OSError, ValueError):
        return repr(ts)


def _headroom_line(health: dict) -> str:
    head = (health or {}).get("headroom") or {}
    if not head:
        return "(no headroom plane)"
    keys = ("flops", "pages", "slots", "hbm")
    return " ".join(f"{k}={float(head[k]):.3f}" for k in keys
                    if k in head)


def render(bundle: dict, tail: int = 8) -> str:
    """One bundle -> text digest (validated by the caller)."""
    lines = []
    lines.append(f"== postmortem: {bundle['replica']} "
                 f"reason={bundle['reason']} "
                 f"at {_fmt_ts(bundle['ts'])} ==")
    extra = bundle.get("extra") or {}
    if extra:
        lines.append("  extra: " + " ".join(
            f"{k}={v}" for k, v in sorted(extra.items())))
    tids = bundle.get("trace_ids") or []
    lines.append(f"  requests on board: {len(tids)}"
                 + (f" (trace ids {tids})" if tids else ""))
    lines.append("  headroom at capture: "
                 + _headroom_line(bundle.get("health")))
    snaps = bundle.get("snapshots") or []
    if snaps:
        lines.append(f"  health trajectory ({len(snaps)} snapshots, "
                     f"newest last):")
        for snap in snaps[-tail:]:
            h = snap.get("health") or {}
            lines.append(
                f"    {_fmt_ts(snap.get('ts', 0.0))} "
                f"queue={h.get('queue_depth', '?')} "
                f"in_flight={h.get('requests_in_flight', '?')} "
                f"occupancy={h.get('slot_occupancy', '?')} "
                f"headroom[{_headroom_line(h)}]")
    summary = bundle.get("anatomy_summary") or {}
    if summary.get("steps"):
        phase = summary.get("phase_frac") or {}
        split = " ".join(f"{p}={v:.1%}" for p, v in sorted(
            phase.items(), key=lambda kv: -kv[1]))
        lines.append(f"  anatomy: {summary['steps']} steps "
                     f"wall={summary.get('wall_s', 0.0):.4g}s "
                     f"host_gap_frac={summary.get('host_gap_frac', 0.0):.3f}"
                     + (f" | {split}" if split else ""))
        if "collective_exposed_frac" in summary:
            lines.append(
                "  collective exposed: "
                f"frac={summary['collective_exposed_frac']:.4f} "
                f"({summary.get('probe_samples', 0)} probe samples)")
    recs = bundle.get("anatomy") or []
    if recs:
        lines.append(f"  last {min(tail, len(recs))} of {len(recs)} "
                     "anatomy records:")
        for rec in recs[-tail:]:
            phases = " ".join(f"{p}={v * 1e3:.2f}ms"
                              for p, v in sorted(rec["phases"].items()))
            lines.append(
                f"    step {rec['step']}: wall={rec['wall_s'] * 1e3:.2f}ms "
                f"gap={rec['host_gap_s'] * 1e3:.2f}ms {phases}")
    ev = (bundle.get("chrome_trace") or {}).get("traceEvents")
    lines.append(f"  chrome trace: {len(ev or [])} events"
                 " (--trace-out to extract)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="bundle JSON file, or a directory of "
                                 "postmortem_*.json dumps")
    ap.add_argument("--tail", type=int, default=8,
                    help="health snapshots / anatomy records to show "
                         "per bundle")
    ap.add_argument("--trace-out", default=None,
                    help="write the (single) bundle's embedded Chrome "
                         "trace to this path for Perfetto")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.observability import flight

    if os.path.isdir(args.path):
        paths = sorted(
            os.path.join(args.path, f) for f in os.listdir(args.path)
            if f.endswith(".json"))
        if not paths:
            print(f"postmortem: FAIL: no .json bundles in {args.path}",
                  file=sys.stderr)
            return 1
    else:
        paths = [args.path]
    if args.trace_out and len(paths) != 1:
        ap.error("--trace-out needs exactly one bundle")

    for path in paths:
        try:
            bundle = flight.validate_postmortem_file(path)
        except (OSError, ValueError) as e:
            print(f"postmortem: FAIL: {path}: {e}", file=sys.stderr)
            return 1
        print(render(bundle, tail=args.tail))
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                json.dump(bundle["chrome_trace"], f)
            print(f"  wrote chrome trace -> {args.trace_out}")
    print(f"postmortem: OK: {len(paths)} bundle(s) validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
