"""Batching of the port: flush strategies, the Batcher and the central
timeout flush."""
