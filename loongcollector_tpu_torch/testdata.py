"""Seeded Apache access-log lines — the port's copy of ``bench.py:gen_lines``
(same generator, same bytes for the same seed), used by ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np

APACHE = (r'(\S+) (\S+) (\S+) \[([^\]]+)\] '
          r'"(\S+) (\S+) ([^"]*)" (\d{3}) (\d+)')
APACHE_KEYS = ["ip", "ident", "user", "time", "method", "url", "protocol",
               "status", "size"]


def gen_lines(n, seed=0):
    rng = np.random.default_rng(seed)
    methods = ["GET", "POST", "PUT", "DELETE", "HEAD"]
    paths = ["/index.html", "/api/v1/users", "/static/app.js", "/favicon.ico",
             "/health", "/api/v2/orders/12345", "/assets/logo.png"]
    lines = []
    for i in range(n):
        ip = f"{rng.integers(1, 255)}.{rng.integers(256)}.{rng.integers(256)}.{rng.integers(1, 255)}"
        m = methods[int(rng.integers(len(methods)))]
        p = paths[int(rng.integers(len(paths)))]
        st = int(rng.integers(100, 599))
        sz = int(rng.integers(0, 10**7))
        lines.append(
            f'{ip} - user{i % 997} [10/Oct/2000:13:55:{i % 60:02d} -0700] '
            f'"{m} {p} HTTP/1.1" {st} {sz}'.encode())
    return lines
