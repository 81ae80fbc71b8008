"""Operator tools over the engine's records: ``profiling`` (the query
history, ``explain("analyze")``'s render, per-query reports, device
traces), ``history`` (the event-log analyses and their CLI) and
``connect_client`` (the stand-alone wire client)."""
