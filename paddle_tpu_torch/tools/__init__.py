"""Command-line tools over the port's telemetry files
(``python -m paddle_tpu_torch.tools.<name>``): ``check_metrics_log``
validates a run log, a span export, a step-anatomy export, a postmortem
bundle or a front-door netlog; ``postmortem`` renders postmortem
bundles."""
