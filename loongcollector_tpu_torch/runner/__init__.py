"""Runners of the port: the processor runner and the input-runner
registry."""
