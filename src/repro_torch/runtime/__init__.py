"""Runtime subsystems of the port: tracing and metrics (:mod:`.telemetry`)."""
