"""DANA core: algorithms, discrete-event async engine, telemetry."""
