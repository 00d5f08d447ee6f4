"""Command-line entry points of the port: ``train_sim`` and the telemetry
renderers ``obs_report`` and ``obs_merge``."""
