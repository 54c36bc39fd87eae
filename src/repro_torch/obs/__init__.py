"""Observability: the span tracer (``trace``). Metrics, drift and the
dispatch profiler wait for ROADMAP.md §1 item 7."""
