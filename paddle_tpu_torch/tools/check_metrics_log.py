"""Schema-validate the port's JSONL telemetry logs.

Usage:
    python -m paddle_tpu_torch.tools.check_metrics_log RUN.jsonl \
        [--require-steps N]
    python -m paddle_tpu_torch.tools.check_metrics_log --trace TRACE.jsonl \
        [--require-spans N]
    python -m paddle_tpu_torch.tools.check_metrics_log --anatomy \
        ANATOMY.jsonl [--require-steps N]
    python -m paddle_tpu_torch.tools.check_metrics_log --postmortem \
        BUNDLE.json
    python -m paddle_tpu_torch.tools.check_metrics_log --netlog \
        NETLOG.jsonl [--require-requests N]

Exit 0 when every record validates (and at least N step/span/request
records exist); exit 1 with a precise message otherwise. It reads a
training run log (``observability.runlog``), a span export
(``Tracer.export_jsonl``), a step-anatomy export
(``StepAnatomy.export_jsonl``: schema, monotonic step ids, phase sums
bounded by wall time), a flight-recorder postmortem bundle
(``observability.flight.write_bundle``) or a front-door netlog
(``serving.fleet.net.FrontDoor``: schema, monotonic frame ids, every
accepted request terminated by exactly one of finished/shed/redriven).
The files of either package pass or fail alike: the schemas are the
reference's (``tools/check_metrics_log.py``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="JSONL log to validate")
    ap.add_argument("--require-steps", type=int, default=0,
                    help="fail unless at least N step records are present")
    ap.add_argument("--trace", action="store_true",
                    help="validate as a trace-span export "
                         "(Tracer.export_jsonl schema) instead of a "
                         "metrics run log")
    ap.add_argument("--require-spans", type=int, default=0,
                    help="with --trace: fail unless at least N span "
                         "records are present")
    ap.add_argument("--anatomy", action="store_true",
                    help="validate as a step-anatomy export "
                         "(StepAnatomy.export_jsonl schema; "
                         "--require-steps gates the record count)")
    ap.add_argument("--postmortem", action="store_true",
                    help="validate as a flight-recorder postmortem "
                         "bundle (single JSON file)")
    ap.add_argument("--netlog", action="store_true",
                    help="validate as a front-door connection/request "
                         "netlog (serving.fleet.net schema; "
                         "--require-requests gates accepted count)")
    ap.add_argument("--require-requests", type=int, default=0,
                    help="with --netlog: fail unless at least N "
                         "requests were accepted")
    args = ap.parse_args(argv)
    # a mismatched flag/mode combination fails fast instead of
    # validating with no minimum-count gate
    if sum((args.trace, args.anatomy, args.postmortem,
            args.netlog)) > 1:
        ap.error("--trace / --anatomy / --postmortem / --netlog are "
                 "exclusive")
    if args.trace and args.require_steps:
        ap.error("--require-steps applies to run logs; "
                 "use --require-spans with --trace")
    if args.require_spans and not args.trace:
        ap.error("--require-spans only applies with --trace")
    if args.postmortem and args.require_steps:
        ap.error("--require-steps does not apply to --postmortem "
                 "(a bundle is one record)")
    if args.netlog and args.require_steps:
        ap.error("--require-steps does not apply to --netlog; "
                 "use --require-requests")
    if args.require_requests and not args.netlog:
        ap.error("--require-requests only applies with --netlog")

    try:
        if args.trace:
            from paddle_tpu_torch.observability import tracing
            n = tracing.validate_trace_log(
                args.path, require_spans=args.require_spans)
            what = "span"
        elif args.anatomy:
            from paddle_tpu_torch.observability import anatomy
            n = anatomy.validate_anatomy_log(
                args.path, require_steps=args.require_steps)
            what = "anatomy"
        elif args.postmortem:
            from paddle_tpu_torch.observability import flight
            flight.validate_postmortem_file(args.path)
            n, what = 1, "postmortem bundle"
        elif args.netlog:
            from paddle_tpu_torch.serving.fleet.net import frontdoor
            summary = frontdoor.validate_netlog_file(
                args.path, require_requests=args.require_requests)
            n, what = summary["accepted_requests"], "accepted request"
        else:
            from paddle_tpu_torch.observability import runlog
            n = runlog.validate_run_log(args.path,
                                        require_steps=args.require_steps)
            what = "step"
    except (OSError, ValueError) as e:
        print(f"check_metrics_log: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"check_metrics_log: OK: {args.path} ({n} {what} records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
