"""Queues of the port: the bounded per-pipeline process queues and their
manager, the sender queues of serialized payloads and their limiters."""
