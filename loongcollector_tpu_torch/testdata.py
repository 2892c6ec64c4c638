"""Seeded test data, used by the tests and ``chip_smoke.py``.

* Apache access-log lines: the port's copy of ``bench.py:gen_lines`` (same
  generator, same bytes for the same seed).
* A multiline Java service log (``gen_java_log``), the patterns of the
  multiline paths, and a ``re`` oracle of their records
  (``java_records``, ``java_oracle``).
* Automata at the DFA kernels' limits.
"""

from __future__ import annotations

import re

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


# -- multiline Java log -------------------------------------------------------

JAVA_START = r"\d{4}-\d{2}-\d{2} .*"
JAVA_CONTINUE = r"(\s+at |\s+\.\.\. \d+ more|Caused by: ).*"
JAVA_PARSE = r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}) (\w+) ([\s\S]*)"
JAVA_KEYS = ["time", "level", "message"]
JAVA_FILTER = r"[\s\S]*(Exception|Error)[\s\S]*"

# automata at the DFA kernels' limits (the tests' and chip_smoke.py's):
# a single DFA at the Tier-2 caps, 64 states and 32 byte classes
LIMIT_DFA = (r"(?:vdb|fnCqp|DJcvwB|ctbd|qG|Jn1bnG|HbIGCw|bewm3|dkssv|"
             r"CgBi13|BE|vzB0|f1qtn)[0-9]+(?:-[a-z]+)*")
# a fused set near the device caps: 124 states, 48 classes
NEAR_CAP_SET = [
    r"(?:Kbs|pIyA|DsqKk|xoliOFm|fzhLeEm|aoGvEE)[0-9]+",
    r"(?:xkd|pzIb|moMAtP|nAJOvGpS|vsGqISvr|jierJ)",
    r"(?:oJBS|sMibhq|bEhoyeA|nMfcRyl|ShSM|nnPnmfA) .*",
    r"(?:jEbByuR|QkeAJi|JTmRSS|jLNFy)[0-9]+",
    r"(?:CJvQkvOj|eyAw|GSw|cMI|SxoSTaN) .*",
]
# 32 members (tests/test_fuse.py): member 31 sets bit 31
BIT31_SET = [chr(ord("a") + i % 26) * (1 + i // 26) + str(i)
             for i in range(32)]

_LOGGERS = ["com.example.order.OrderService", "com.example.http.Dispatcher",
            "com.example.db.ConnectionPool", "org.acme.cache.LruCache",
            "org.acme.auth.TokenFilter", "io.shop.cart.CartController"]
_TEXTS = ["request handled in {n} ms", "cache miss for key user:{n}",
          "ErrorHandler registered for route /api/v{n}",
          "pool size {n}, idle {n}", "retrying upstream call #{n}",
          "session {n} expired", "flushed {n} records"]
_EXCEPTIONS = ["NullPointerException", "IllegalStateException",
               "IllegalArgumentException", "IndexOutOfBoundsException",
               "UnsupportedOperationException", "ArithmeticException"]
_FRAMES = ["com.example.order.OrderService.process",
           "com.example.http.Dispatcher.dispatch",
           "com.example.db.ConnectionPool.borrow",
           "org.acme.cache.LruCache.get", "java.util.HashMap.get",
           "sun.reflect.NativeMethodAccessorImpl.invoke0",
           "org.apache.catalina.core.StandardWrapperValve.invoke"]


def gen_java_log(n_lines, seed=0):
    """``n_lines`` physical lines of a seeded Java service log: header lines
    ``YYYY-MM-DD HH:MM:SS LEVEL logger - text``; about one record in five
    ERROR or WARN, its header ending ``java.lang.XxxException: msg`` and
    followed by 5-40 ``\\tat pkg.Class.method(File.java:N)`` frames; a third
    of those add a ``Caused by: ...`` section, its own frames and a
    ``\\t... N more`` line.  About one error record in 500 has 100-150
    frames (a record over 4096 bytes) and, independently, about one in 500
    an exception message over 4096 bytes on its header line.  Every header
    matches ``JAVA_START``, every other line ``JAVA_CONTINUE``; the last
    record may be cut short at ``n_lines``."""
    rng = np.random.default_rng(seed)
    lines = []
    t = 0
    while len(lines) < n_lines:
        t += int(rng.integers(0, 3))
        ts = (f"2024-03-{1 + t // 86400 % 28:02d} {t // 3600 % 24:02d}:"
              f"{t // 60 % 60:02d}:{t % 60:02d}")
        logger = _LOGGERS[int(rng.integers(len(_LOGGERS)))]
        text = _TEXTS[int(rng.integers(len(_TEXTS)))].format(
            n=int(rng.integers(1, 10**5)))
        if rng.integers(5):
            level = ("INFO", "DEBUG")[int(rng.integers(2))]
            lines.append(f"{ts} {level} {logger} - {text}".encode())
            continue
        level = ("ERROR", "WARN")[int(rng.integers(2))]
        exc = _EXCEPTIONS[int(rng.integers(len(_EXCEPTIONS)))]
        msg = f"failed on id {int(rng.integers(10**6))}"
        if rng.integers(500) == 0:
            msg += " payload=" + "".join(
                "0123456789abcdef"[int(x)]
                for x in rng.integers(0, 16, int(rng.integers(4200, 5000))))
        lines.append(f"{ts} {level} {logger} - {text} "
                     f"java.lang.{exc}: {msg}".encode())
        n_frames = (int(rng.integers(100, 151)) if rng.integers(500) == 0
                    else int(rng.integers(5, 41)))
        sections = [n_frames]
        if rng.integers(3) == 0:
            sections.append(int(rng.integers(5, 41)))
        for k, n in enumerate(sections):
            if k:
                cause = _EXCEPTIONS[int(rng.integers(len(_EXCEPTIONS)))]
                lines.append(f"Caused by: java.lang.{cause}: nested "
                             f"{int(rng.integers(100))}".encode())
            for _ in range(n):
                fn = _FRAMES[int(rng.integers(len(_FRAMES)))]
                cls = fn.rsplit(".", 2)[-2]
                lines.append(f"\tat {fn}({cls}.java:"
                             f"{int(rng.integers(1, 900))})".encode())
            if k:
                lines.append(f"\t... {int(rng.integers(1, 60))} "
                             f"more".encode())
    return lines[:n_lines]


def java_records(lines, continue_pattern=None):
    """The records of a start-mode multiline split over the whole file, by
    ``re.fullmatch`` (the reference's block walk): a start line opens a
    record that runs to the line before the next start line or, with a
    continue pattern, while the next line continues it; any other line is
    a record of its own."""
    start = re.compile(JAVA_START.encode())
    cont = re.compile(continue_pattern.encode()) if continue_pattern \
        else None
    out = []
    i, n = 0, len(lines)
    while i < n:
        j = i
        if start.fullmatch(lines[i]):
            while j + 1 < n and (cont.fullmatch(lines[j + 1]) if cont
                                 else not start.fullmatch(lines[j + 1])):
                j += 1
        out.append(b"\n".join(lines[i:j + 1]))
        i = j + 1
    return out


def java_oracle(records, filter_pattern=None):
    """What the parse (and the filter on ``message``) leave of ``records``,
    in order: the fields of each record the parse regex takes, else the
    record as ``rawLog``; with a filter, only parsed records whose message
    the filter fully matches."""
    parse = re.compile(JAVA_PARSE.encode())
    keep = re.compile(filter_pattern.encode()) if filter_pattern else None
    out = []
    for r in records:
        m = parse.fullmatch(r)
        if m is None:
            if keep is None:
                out.append({"rawLog": r.decode()})
            continue
        if keep is None or keep.fullmatch(m.group(3)):
            out.append({k: v.decode() for k, v in zip(JAVA_KEYS, m.groups())})
    return out


def java_filter_config(log_path, out_path):
    """The multiline Java config with a continue pattern and an exception
    filter, as YAML: ``input_file`` with Multiline start and continue,
    ``processor_parse_regex_tpu``, ``processor_filter_native`` on the
    message, ``flusher_file``."""
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
    Multiline:
      StartPattern: '{JAVA_START}'
      ContinuePattern: '{JAVA_CONTINUE}'
processors:
  - Type: processor_parse_regex_tpu
    Regex: '{JAVA_PARSE}'
    Keys: [time, level, message]
  - Type: processor_filter_native
    Include:
      message: '{JAVA_FILTER}'
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""
