"""Runtime helpers of the port: the metrics ring the service logs into."""

from repro_torch.runtime.metrics import MetricsLogger
