"""L7 MySQL protocol parsing for captured network payloads.

Reference: loongcollector_tpu/input/ebpf/protocol_mysql.py
(core/ebpf/protocol/mysql/) — the network observer decodes the
MySQL client/server packet framing (3-byte LE length + sequence id) into
command records (COM_QUERY text, prepared-statement ops) and response
outcomes (OK / ERR with code + message / result set).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

COMMANDS = {
    0x01: b"QUIT", 0x02: b"INIT_DB", 0x03: b"QUERY", 0x04: b"FIELD_LIST",
    0x0E: b"PING", 0x16: b"STMT_PREPARE", 0x17: b"STMT_EXECUTE",
    0x19: b"STMT_CLOSE", 0x1C: b"STMT_FETCH",
}

MAX_SQL = 1024


@dataclass
class MySQLRecord:
    kind: str = ""            # request | response
    command: bytes = b""      # QUERY / STMT_PREPARE / ...
    sql: bytes = b""
    ok: bool = False
    error_code: int = 0
    error_message: bytes = b""
    column_count: int = -1


def parse_mysql(payload: bytes) -> Optional[MySQLRecord]:
    """One captured segment starting at a packet boundary → record.

    Framing check is strict (declared length must cover the payload we
    see, capped by capture truncation) so random text never misparses.
    """
    if len(payload) < 5:
        return None
    plen = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    seq = payload[3]
    if plen == 0 or plen > (1 << 20):
        return None   # implausible frame: not MySQL
    body = payload[4:4 + plen]
    if len(body) < 1:
        return None
    complete = len(payload) - 4 >= plen
    # incomplete frames are only trusted when the capture obviously hit
    # its snapshot cap — random text has a garbage length that neither
    # completes nor looks truncated-by-capture
    if not complete and len(payload) < 1024:
        return None
    first = body[0]
    rec = MySQLRecord()
    if seq == 0 and first in COMMANDS:
        rec.kind = "request"
        rec.command = COMMANDS[first]
        if first in (0x03, 0x16, 0x02, 0x04):   # text follows the command
            rec.sql = bytes(body[1:MAX_SQL + 1])
        return rec
    if seq == 0:
        return None   # client packet with unknown command: not MySQL
    if seq > 7:
        return None   # responses start at low sequence ids; random bytes
        # in the seq slot are the main false-positive source
    rec.kind = "response"
    if first == 0x00:
        rec.ok = True
    elif first == 0xFF:
        if len(body) < 3:
            return None
        rec.error_code = body[1] | (body[2] << 8)
        msg = body[3:]
        if msg.startswith(b"#") and len(msg) > 6:
            msg = msg[6:]             # skip SQLSTATE marker
        rec.error_message = bytes(msg[:256])
    elif first == 0xFE and plen < 9:
        rec.ok = True                 # EOF packet
    elif 0x01 <= first <= 0xFA:
        rec.column_count = first      # result-set header (lenenc small int)
    else:
        return None
    return rec
