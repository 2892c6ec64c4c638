"""Process queues of the port: bounded per-pipeline queues and their manager."""
