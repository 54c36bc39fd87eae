"""Slot-based continuous batching over the LM (``server.SlotServer``)."""
