"""Flusher routing: each flusher's ``Match`` condition."""
