"""L7 Redis (RESP) protocol parsing for captured network payloads.

Reference: loongcollector_tpu/input/ebpf/protocol_redis.py
(core/ebpf/protocol/redis/) — RESP2 framing: requests are arrays
of bulk strings (*N / $len), responses are simple strings (+), errors (-),
integers (:), bulk ($) or arrays (*). Inline commands are accepted for
requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

MAX_PREVIEW = 256

# commands we recognise for the inline form (strict: random text that
# happens to lack RESP markers must not parse as Redis)
_KNOWN = {b"GET", b"SET", b"DEL", b"INCR", b"DECR", b"EXPIRE", b"TTL",
          b"PING", b"ECHO", b"EXISTS", b"HGET", b"HSET", b"HDEL", b"LPUSH",
          b"RPUSH", b"LPOP", b"RPOP", b"LRANGE", b"SADD", b"SREM", b"AUTH",
          b"SELECT", b"SUBSCRIBE", b"PUBLISH", b"XADD", b"ZADD", b"MGET",
          b"MSET", b"KEYS", b"SCAN", b"INFO", b"CONFIG", b"CLUSTER"}


@dataclass
class RedisRecord:
    kind: str = ""            # request | response
    command: bytes = b""
    key: bytes = b""
    ok: bool = False
    error: bytes = b""
    value_preview: bytes = b""


def _bulk_strings(payload: bytes, n: int, pos: int) -> List[bytes]:
    out: List[bytes] = []
    for _ in range(n):
        if pos >= len(payload) or payload[pos:pos + 1] != b"$":
            break
        nl = payload.find(b"\r\n", pos)
        if nl < 0:
            break
        try:
            ln = int(payload[pos + 1:nl])
        except ValueError:
            break
        if ln < 0:
            out.append(b"")
            pos = nl + 2
            continue
        out.append(bytes(payload[nl + 2:nl + 2 + ln]))
        pos = nl + 2 + ln + 2
    return out


def parse_redis(payload: bytes) -> Optional[RedisRecord]:
    if not payload:
        return None
    first = payload[:1]
    rec = RedisRecord()
    if first == b"*":
        nl = payload.find(b"\r\n")
        if nl < 0:
            return None
        try:
            n = int(payload[1:nl])
        except ValueError:
            return None
        args = _bulk_strings(payload, min(n, 8), nl + 2)
        if args:
            # request (array of bulk strings): command + key
            rec.kind = "request"
            rec.command = args[0].upper()
            if len(args) > 1:
                rec.key = args[1][:MAX_PREVIEW]
            return rec
        rec.kind = "response"
        rec.ok = True
        rec.value_preview = b"*%d" % n
        return rec
    if first == b"+":
        rec.kind = "response"
        rec.ok = True
        rec.value_preview = payload[1:payload.find(b"\r\n")][:MAX_PREVIEW] \
            if b"\r\n" in payload else payload[1:MAX_PREVIEW]
        return rec
    if first == b"-":
        rec.kind = "response"
        rec.error = payload[1:payload.find(b"\r\n")][:MAX_PREVIEW] \
            if b"\r\n" in payload else payload[1:MAX_PREVIEW]
        return rec
    if first == b":":
        rec.kind = "response"
        rec.ok = True
        rec.value_preview = payload[1:payload.find(b"\r\n")][:MAX_PREVIEW] \
            if b"\r\n" in payload else payload[1:MAX_PREVIEW]
        return rec
    if first == b"$":
        nl = payload.find(b"\r\n")
        if nl < 0:
            return None
        rec.kind = "response"
        rec.ok = payload[1:nl] != b"-1"
        rec.value_preview = bytes(payload[nl + 2:nl + 2 + MAX_PREVIEW]
                                  .rstrip(b"\r\n"))
        return rec
    # inline command (request without RESP framing)
    line = payload.split(b"\r\n", 1)[0].split(b"\n", 1)[0]
    parts = line.split()
    if parts and parts[0].upper() in _KNOWN:
        rec.kind = "request"
        rec.command = parts[0].upper()
        if len(parts) > 1:
            rec.key = parts[1][:MAX_PREVIEW]
        return rec
    return None
