"""L7 HTTP protocol parsing for captured network payloads.

Reference: loongcollector_tpu/input/ebpf/protocol_http.py
(core/ebpf/protocol/http/) — the network observer parses captured
request/response bytes into structured records (method, path, version,
status, headers of interest).

Request-line/status-line extraction is span-based so batches of payloads can
flow through the same columnar machinery as log lines; header scanning is a
bounded host pass (headers live in the first KB).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

_METHODS = (b"GET", b"POST", b"PUT", b"DELETE", b"HEAD", b"OPTIONS",
            b"PATCH", b"CONNECT", b"TRACE")


@dataclass
class HTTPRecord:
    kind: str = ""            # request | response
    method: bytes = b""
    path: bytes = b""
    version: bytes = b""
    status: int = 0
    host: bytes = b""
    content_length: int = -1
    user_agent: bytes = b""


def parse_http(payload: bytes, max_headers: int = 32) -> Optional[HTTPRecord]:
    """Parse the first request/status line + interesting headers."""
    end = payload.find(b"\r\n")
    if end < 0:
        end = payload.find(b"\n")
        if end < 0:
            return None
    first = payload[:end]
    rec = HTTPRecord()
    if first.startswith(b"HTTP/"):
        parts = first.split(b" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            return None
        rec.kind = "response"
        rec.version = parts[0]
        rec.status = int(parts[1])
    else:
        parts = first.split(b" ")
        if len(parts) != 3 or parts[0] not in _METHODS:
            return None
        rec.kind = "request"
        rec.method, rec.path, rec.version = parts
    # headers
    pos = end + (2 if payload[end:end + 2] == b"\r\n" else 1)
    for _ in range(max_headers):
        nxt = payload.find(b"\n", pos)
        if nxt < 0:
            break
        line = payload[pos:nxt].rstrip(b"\r")
        pos = nxt + 1
        if not line:
            break
        k, sep, v = line.partition(b":")
        if not sep:
            continue
        key = k.strip().lower()
        val = v.strip()
        if key == b"host":
            rec.host = val
        elif key == b"content-length" and val.isdigit():
            rec.content_length = int(val)
        elif key == b"user-agent":
            rec.user_agent = val
    return rec
