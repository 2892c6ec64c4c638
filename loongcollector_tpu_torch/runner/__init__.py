"""Runners of the port: the processor runner, the input-runner registry
and the send path (flusher runner, HTTP sink, circuit breaker, disk
buffer)."""
