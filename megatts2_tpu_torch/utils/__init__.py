from .logging import MetricsLogger, ProfilerHook, StepTimer
