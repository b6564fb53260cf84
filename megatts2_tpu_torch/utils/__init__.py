from .logging import MetricsLogger, ProfilerHook
