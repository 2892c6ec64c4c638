"""Runners of the port: the processor runner."""
