"""Serving plane of the port: engine, admission scheduler, telemetry."""
