"""Deterministic synthetic LM data (``pipeline``), a copy of ``repro.data``."""
