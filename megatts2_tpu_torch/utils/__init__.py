from .logging import MetricsLogger, StepTimer
