"""Seeded test data, used by the tests and ``chip_smoke.py``.

* Apache access-log lines: the port's copy of ``bench.py:gen_lines`` (same
  generator, same bytes for the same seed).
* A multiline Java service log (``gen_java_log``), the patterns of the
  multiline paths, and a ``re`` oracle of their records
  (``java_records``, ``java_oracle``).
* Automata at the DFA kernels' limits, and rows for the settled exit
  (``settle_rows``, ``cap_automaton``).
* The Apache-filter path (``apache_filter_config``: parse, then keep the
  4xx/5xx responses that are not health checks) and its ``re`` oracle
  (``apache_filter_oracle``).
* Named stage lists of the fused stage program (K7) and rows for them
  (``fused_stage_lists``).
* The URL-classified Apache path (``url_classify_config``: parse, drop
  ``/favicon.ico``, classify the url by ``URL_RULES``) and its ``re``
  oracle (``url_classify_oracle``); the eBPF network observer's raw-event
  stream (``ebpf_stream``: exec'd processes, connections, HTTP, Redis and
  MySQL exchanges) and what the observer must make of it.
"""

from __future__ import annotations

import re

import numpy as np

APACHE = (r'(\S+) (\S+) (\S+) \[([^\]]+)\] '
          r'"(\S+) (\S+) ([^"]*)" (\d{3}) (\d+)')
APACHE_KEYS = ["ip", "ident", "user", "time", "method", "url", "protocol",
               "status", "size"]


APACHE_PATHS = ["/index.html", "/api/v1/users", "/static/app.js",
                "/favicon.ico", "/health", "/api/v2/orders/12345",
                "/assets/logo.png"]


def gen_lines(n, seed=0):
    rng = np.random.default_rng(seed)
    methods = ["GET", "POST", "PUT", "DELETE", "HEAD"]
    paths = APACHE_PATHS
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

# rows for the settled exit (settle_rows): a prefix that ends in a settled
# state of the automaton, and a filler byte run that never reaches one
SETTLE_KINDS = {
    # JAVA_FILTER: "Error" settles the walk on its last byte; lowercase
    # letters never do
    "java_filter": (lambda n: b"Error", 0x61, 0x7B),
    # the fused start/continue set: spaces keep `\s+at ` open, and an "x"
    # after them is the dead state; spaces alone never settle
    "java_start_continue": (lambda n: b"x", 0x20, 0x21),
}
SETTLE_LENGTHS = (0, 1, 15, 16, 17, 511, 512, 513, 1023, 1024, 1025, 4096)
# positions (the byte the walk settles on, counted from 1) at 16-byte word
# edges (where the exit is checked) and 512-byte edges, +-1
SETTLE_EDGES = (15, 16, 17, 31, 32, 33, 511, 512, 513, 1023, 1024, 1025)


def settle_rows(kind, L, seed=0):
    """Rows of at most ``L`` bytes for the settled exit of one automaton
    (``SETTLE_KINDS``): rows that never settle, at every length of
    ``SETTLE_LENGTHS``; rows that settle on their last byte; rows that
    settle at each of ``SETTLE_EDGES`` and run on to ``L``; seeded ones."""
    tail, lo, hi = SETTLE_KINDS[kind]
    rng = np.random.default_rng(seed)

    def filler(n):
        return bytes(rng.integers(lo, hi, n, dtype=np.uint8))

    def settled_at(p, n):
        t = tail(p)
        return filler(p - len(t)) + t + filler(n - p)

    out = [filler(n) for n in SETTLE_LENGTHS if n <= L]
    out += [settled_at(n, n) for n in SETTLE_LENGTHS if 5 <= n <= L]
    out += [settled_at(p, L) for p in SETTLE_EDGES if 5 <= p <= L]
    for _ in range(24):
        n = int(rng.integers(0, L + 1))
        out.append(settled_at(int(rng.integers(5, n + 1)), n) if n >= 5
                   and rng.integers(2) else filler(n))
    return out


def cap_automaton(seed=0, S=128, settled=28):
    """A seeded automaton at the DFA kernels' 128-state cap, as (t256 u8
    [S, 256], accept i32 [S], start): the last ``settled`` states are
    closed under every byte and share one accept value, and only ``Z``
    (from any open state) enters them; the open states' accept values are
    0, 1 or 2."""
    rng = np.random.default_rng(seed)
    n_open = S - settled
    t256 = rng.integers(0, n_open, (S, 256)).astype(np.uint8)
    t256[:n_open, ord("Z")] = n_open
    t256[n_open:] = rng.integers(n_open, S, (settled, 256)).astype(np.uint8)
    accept = rng.integers(0, 3, S).astype(np.int32)
    accept[n_open:] = 7
    return t256, accept, 3


#: K4's skip automata beside path 2's set: after ``x`` (``y``) a state
#: that only b, c, d, e (and f) leave: four escape bytes, a skip state; five,
#: not one
SKIP4_SET = [r"x[^bcde]*", r"y[^bcdef]*"]
SKIP_HEADS = {"java": (b"2024-03-01 12:00:01 INFO ", b"\n"),
              "java_frame": (b"\tat com.example.Foo.bar(Foo.java:", b"\n"),
              "skip4": (b"x", b"bcde"), "skip5": (b"y", b"bcdef")}


def skip_rows(kind, L, seed=0):
    """Rows for K4's skip (``SKIP_HEADS``: a head that leads the fused
    walk into a state few bytes leave, and those escape bytes), as (bytes,
    length) pairs whose bytes may run past the length: filler without an
    escape byte after the head, then one escape byte at each 16-byte word
    edge +-1 with the row cut after it, exactly at the length, and one
    past the length; rows with an escape byte inside and more filler after
    it; rows with no escape byte; lengths 0 and 1."""
    rng = np.random.default_rng(seed)
    head, escapes = SKIP_HEADS[kind]
    keep = np.array([b for b in range(32, 127) if b not in escapes], np.uint8)

    def filler(n):
        return bytes(rng.choice(keep, n))

    out = []
    for p in sorted({q for k in range(1, L // 16 + 1)
                     for q in (16 * k - 1, 16 * k, 16 * k + 1)}):
        if not len(head) <= p < L:
            continue
        e = escapes[int(rng.integers(len(escapes)))]
        row = head + filler(p - len(head)) + bytes([e]) \
            + filler(L - p - 1)
        out += [(row, L), (row, p + 1), (row, p), (row, max(p - 1, 0))]
    for _ in range(24):
        n = int(rng.integers(len(head), L + 1))
        row = bytearray(head + filler(L - len(head)))
        for q in rng.integers(len(head), L, int(rng.integers(1, 4))):
            row[q] = escapes[int(rng.integers(len(escapes)))]
        out.append((bytes(row), n))
        out.append((head + filler(n - len(head)), n))
    out += [(head[:1], 1), (b"", 0), (head, len(head))]
    return [(r[:L], min(n, L)) for r, n in out]


def skip_matrix(pairs, L, B=None):
    """(rows u8 [B, L], lengths i32 [B]) of ``skip_rows`` pairs: each row's
    bytes from column 0 (past its length too), then padding rows."""
    B = B or len(pairs) + 3
    rows = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, (r, n) in enumerate(pairs):
        rows[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = n
    return rows, lengths


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


def java_groups(lines, chunk_size):
    """The records of each group a one-shot read of ``lines`` (as a file)
    makes with the start and continue patterns, in order: the reader's
    chunks of at most ``chunk_size`` bytes (``input/file/reader.py``), each
    ending at a newline and, while it fills its read, rolled back to its
    last start line; then split_multiline's records of each chunk, the last
    chunk's last record held for the stop-time drain.  Every record must be
    shorter than a chunk (none ships broken)."""
    data = b"\n".join(lines) + b"\n"
    start = re.compile(JAVA_START.encode())
    groups = []
    off = 0
    while off < len(data):
        piece = data[off:off + chunk_size]
        filled = len(piece) == chunk_size
        aligned = piece[:piece.rfind(b"\n") + 1]
        body = aligned[:-1].split(b"\n")
        last = max(i for i, ln in enumerate(body) if start.fullmatch(ln))
        if filled:
            if last == 0:
                raise ValueError("a record longer than a chunk")
            body = body[:last]
            aligned = b"\n".join(body) + b"\n"
        records = java_records(body, JAVA_CONTINUE)
        groups.append(records if filled else records[:-1])
        off += len(aligned)
    return groups


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


# -- the Apache-filter path ---------------------------------------------------

APACHE_FILTER_INCLUDE = {"status": r"[45]\d\d"}
APACHE_FILTER_EXCLUDE = {"url": "/health"}


def apache_config(log_path, out_path):
    """The main path's config, as YAML: the shipped
    ``example_config/quick_start/file_regex_apache.yaml`` (``input_file``,
    ``processor_parse_regex_tpu`` with the Apache pattern and keys,
    ``processor_parse_timestamp_native`` on ``time``) with ``FilePaths``
    pointed at ``log_path`` and a ``flusher_file`` sink at ``out_path``."""
    keys = ", ".join(APACHE_KEYS)
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
    TailingAllMatchedFiles: true
processors:
  - Type: processor_parse_regex_tpu
    SourceKey: content
    Regex: '{APACHE}'
    Keys: [{keys}]
  - Type: processor_parse_timestamp_native
    SourceKey: time
    SourceFormat: '%d/%b/%Y:%H:%M:%S %z'
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def apache_oracle(lines):
    """The fields ``re.fullmatch`` of the Apache pattern gives each line
    (None for a line it does not match), in order."""
    rx = re.compile(APACHE.encode())
    out = []
    for line in lines:
        m = rx.fullmatch(line)
        out.append(None if m is None else
                   {k: v.decode() for k, v in zip(APACHE_KEYS, m.groups())})
    return out


def apache_filter_config(log_path, out_path):
    """The Apache-filter config, as YAML: ``input_file``,
    ``processor_parse_regex_tpu`` with the shipped Apache pattern and keys
    (``file_regex_apache.yaml``), ``processor_filter_native`` keeping the
    4xx/5xx statuses that are not ``/health``, ``flusher_file``."""
    keys = ", ".join(APACHE_KEYS)
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_parse_regex_tpu
    SourceKey: content
    Regex: '{APACHE}'
    Keys: [{keys}]
  - Type: processor_filter_native
    Include:
      status: '{APACHE_FILTER_INCLUDE["status"]}'
    Exclude:
      url: '{APACHE_FILTER_EXCLUDE["url"]}'
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def apache_filter_oracle(lines):
    """The fields of the lines the Apache-filter path keeps, in order:
    ``re.fullmatch`` of the pattern, then status matching the Include and
    url not matching the Exclude (a line that fails the parse has no
    status, so it is dropped)."""
    rx = re.compile(APACHE.encode())
    inc = re.compile(APACHE_FILTER_INCLUDE["status"].encode())
    exc = re.compile(APACHE_FILTER_EXCLUDE["url"].encode())
    st, url = APACHE_KEYS.index("status"), APACHE_KEYS.index("url")
    out = []
    for line in lines:
        m = rx.fullmatch(line)
        if m is None or not inc.fullmatch(m.group(st + 1)) \
                or exc.fullmatch(m.group(url + 1)):
            continue
        out.append({k: v.decode() for k, v in zip(APACHE_KEYS, m.groups())})
    return out


# -- stage lists of the fused stage program ----------------------------------

THREE_STAGE_SOURCE = r"[a-z]+ \d+"
THREE_STAGE_RX = r"([a-z]+) (\d+)"
THREE_STAGE_NUM = r"1\d*"
GROK_SET = [r"%{WORD:w} %{INT:n}", r"%{WORD:w} %{WORD:v}"]
IP_PIVOT = r"(\d+)\.\d+\.\d+\.\d+ - (.*)"
NESTED_RX = r"(\w+)(?:-(\d+)(?:-(x|y+))?)? end"
DOUBLE_PIVOT = r"(\w+) (.*?) - (.*?) end"


def fused_stage_lists():
    """The stage lists K7 is held to, as (name, specs, rows) with ``rows(rng,
    n, L)`` making n rows of at most L bytes for the list:

    * ``three_stage`` — the reference's THREE_STAGE: a filter on the
      source (``extract_ok``), the parse, a filter on a capture
      (``span_match``);
    * ``extract_ok`` — the Apache parse, then a source condition on the
      general walker (a pivot program);
    * ``match_scan`` — a DFA ``match`` condition, grok's classify set and
      the multiline start/continue set (terminal);
    * ``apache_filter`` — the Apache-filter path's program;
    * ``over_budget`` — a keep stage of eight 64-state conditions, whose
      tables pass the shared-memory budget at L=4096;
    * ``bit31`` — a 32-member scan (member 31 sets tag bit 31) and a
      match condition;
    * ``nested`` — a nested first extract program (Optional_ and Alt: the
      general walker), a span condition on its optional capture, and a
      double-pivot ``extract_ok`` condition;
    * ``device_sections`` — the Apache parse, a keep of negated conditions
      (five 64-state automata and a literal sized to fill the shared part
      of K7's descriptor), then a pivot extract program, a span automaton
      on each extract stage and an ``extract_ok`` program, which all sit
      in device memory;
    * ``four_conds`` — the Apache parse and a keep of four conditions of
      every kind: a row match, a pivot ``extract_ok``, a negated span and
      a span.

    The specs are built from the patterns as the processors build them."""
    from .ops import fused_pipeline as fp
    from .ops.kernels.dfa_scan import (DFAMatchKernel, FusedScanKernel,
                                       LazySpanMatchKernel)
    from .ops.kernels.field_extract import ExtractKernel
    from .ops.regex.dfa import compile_dfa
    from .ops.regex.fuse import compile_fused
    from .ops.regex.grok import expand
    from .ops.regex.program import compile_tier1

    def extract(pattern):
        kern = ExtractKernel(compile_tier1(pattern))
        return fp.StageSpec("extract", kern.program, ["extract", pattern],
                            staged=kern)

    def extract_ok(pattern, negate=False):
        kern = ExtractKernel(compile_tier1(pattern))
        return fp.StageCond("extract_ok", kern.program,
                            ["extract_ok", pattern, negate], negate=negate,
                            staged=kern)

    def match(pattern, negate=False):
        kern = DFAMatchKernel(compile_dfa(pattern))
        return fp.StageCond("match", kern.dfa, ["match", pattern, negate],
                            negate=negate, staged=kern)

    def span(pattern, prod, cap, negate=False):
        dfa = compile_dfa(pattern)
        return fp.StageCond("span_match", dfa,
                            ["span_match", pattern, prod, cap, negate],
                            binding=(prod, cap), negate=negate,
                            staged=LazySpanMatchKernel(dfa))

    def keep(*conds):
        return fp.StageSpec("keep", list(conds),
                            ["keep"] + [list(c.ident) for c in conds])

    def scan(patterns, terminal=False):
        fdfa = compile_fused(patterns)
        return fp.StageSpec("scan", fdfa, ["scan"] + list(fdfa.patterns),
                            staged=FusedScanKernel(fdfa), terminal=terminal)

    status, url = APACHE_KEYS.index("status"), APACHE_KEYS.index("url")
    grok_set = [expand(p) for p in GROK_SET]
    return [
        ("three_stage",
         [keep(extract_ok(THREE_STAGE_SOURCE)), extract(THREE_STAGE_RX),
          keep(span(THREE_STAGE_NUM, 1, 1))], _word_num_rows),
        ("extract_ok",
         [extract(APACHE), keep(extract_ok(IP_PIVOT),
                                extract_ok(r"(\S+) .*", negate=True))],
         _apache_rows),
        ("match_scan",
         [keep(match(JAVA_FILTER)), scan(grok_set),
          scan([JAVA_START, JAVA_CONTINUE], terminal=True)], _java_rows),
        ("apache_filter",
         [extract(APACHE),
          keep(span(APACHE_FILTER_INCLUDE["status"], 0, status),
               span(APACHE_FILTER_EXCLUDE["url"], 0, url, negate=True))],
         _apache_rows),
        ("over_budget",
         [keep(*(match(LIMIT_DFA, negate=bool(i % 2 and i < 6))
                 for i in range(8)))], _limit_rows),
        ("bit31", [scan(BIT31_SET), keep(match(LIMIT_DFA))], _bit31_rows),
        ("nested",
         [extract(NESTED_RX),
          keep(span(r"\d+7", 0, 1, negate=True),
               extract_ok(DOUBLE_PIVOT, negate=True))], _nested_rows),
        ("device_sections", _fill_shared(
            [extract(APACHE)], [match(LIMIT_DFA, negate=True)] * 5,
            lambda k: match("q" * k, negate=True),
            [extract(IP_PIVOT),
             keep(span(APACHE_FILTER_INCLUDE["status"], 0, status),
                  extract_ok(DOUBLE_PIVOT, negate=True),
                  span(r"\d*[02468]", 2, 0))], keep), _apache_rows),
        ("four_conds",
         [extract(APACHE),
          keep(match(r"\d+\.\d+\.\d+\.\d+ .*"), extract_ok(IP_PIVOT),
               span(APACHE_FILTER_EXCLUDE["url"], 0, url, negate=True),
               span(APACHE_FILTER_INCLUDE["status"], 0, status))],
         _apache_rows),
    ]


def _fill_shared(head, fillers, literal, tail, keep):
    """``head``, a keep stage of ``fillers`` and one ``literal(k)``
    condition, then ``tail``: k picked so that the shared part of K7's
    descriptor ends less than one automaton state (65 words) short of its
    cap, so that every section of ``tail`` lies in device memory."""
    from .ops import fused_pipeline as fp
    from .ops.kernels import fused_program_cuda as fpc

    def stages(k):
        return head + [keep(*fillers, literal(k))] + tail

    ks = fp.kernel_stages(stages(1))
    desc = fpc.pack_descriptor(ks)
    n_conds = sum(len(st.conds) for st in ks)
    used = fpc.HEADER_WORDS + fpc.RECORD_WORDS * len(ks) \
        + fpc.COND_WORDS * n_conds
    used += sum(len(st.obj.blob) for st in ks[:len(head)])
    used += sum(len(fpc._automaton_words(c.obj))
                for c in ks[len(head)].conds[:-1])
    # the literal of k bytes is a (k + 2)-state automaton: 4 + 65 (k + 2)
    # words, and the shared part is a multiple of 4 words
    room = fpc.shared_cap(desc.caps_words) - used - 3
    return stages((room - 4) // 65 - 2)


def _fit(rng, pool, n, L):
    """n rows of the pool cut to L, in a seeded order, with rows exactly L
    long, empty rows, and a few bytes changed in some."""
    out = []
    for _ in range(n):
        line = pool[int(rng.integers(len(pool)))][:L]
        if line and rng.integers(5) == 0:
            i = int(rng.integers(len(line)))
            line = line[:i] + bytes([int(rng.integers(32, 127))]) \
                + line[i + 1:]
        out.append(line)
    out[:3] = [b"", (out[3] * (L // max(len(out[3]), 1) + 1))[:L],
               bytes(rng.integers(32, 127, L, dtype=np.uint8))]
    return out


def _word_num_rows(rng, n, L):
    words = [b"abc", b"zz", b"q", b"deep", b"nope!", b"x" * 40]
    pool = [w + b" " + str(int(rng.integers(0, 10 ** int(rng.integers(1, 7)))))
            .encode() for w in words for _ in range(8)]
    pool += [b"mixed 9x", b"yy 25", b"1 abc", b"abc  12", b"abc 1" * 30]
    return _fit(rng, pool, n, L)


def _apache_rows(rng, n, L):
    pool = gen_lines(400, seed=int(rng.integers(1000)))
    pool += [ln.replace(b" HTTP/", b"x" * 60 + b" HTTP/") for ln in pool[:40]]
    return _fit(rng, pool, n, L)


def _java_rows(rng, n, L):
    lines = gen_java_log(600, seed=int(rng.integers(1000)))
    pool = lines + [b"\n".join(lines[i:i + k]) for i, k in
                    ((3, 5), (50, 20), (100, 60))]
    pool += [b"abc 123", b"abc def", b"!!", b"zz 9"]
    return _fit(rng, pool, n, L)


def _limit_rows(rng, n, L):
    pool = [b"vdb12", b"fnCqp3-ab", b"DJcvwB7-x-yz", b"ctbd", b"qG99",
            b"Jn1bnG0-q", b"HbIGCw5", b"nope", b"BE1-a-b-c-d"]
    pool += [p + b"-" + b"k" * int(rng.integers(0, 200)) for p in pool]
    return _fit(rng, pool, n, L)


def _bit31_rows(rng, n, L):
    pool = [p.encode() for p in BIT31_SET] + [b"vdb12", b"zz", b"a0b"]
    return _fit(rng, pool, n, L)


def _nested_rows(rng, n, L):
    words = [b"abc", b"zz9", b"q", b"ab_c"]
    pool = []
    for _ in range(60):
        line = words[int(rng.integers(len(words)))]
        if rng.integers(3):
            line += b"-" + str(int(rng.integers(0, 10 ** 4))).encode()
            if rng.integers(2):
                line += b"-" + [b"x", b"yy", b"z", b"y"][int(rng.integers(4))]
        pool.append(line + [b" end", b" end", b"end", b" x"][
            int(rng.integers(4))])
    pool += [b"ab x - y end", b"cat  -  end", b"dog a - b - c end",
             b"abc-17 end", b"abc-7-x end"]
    return _fit(rng, pool, n, L)


# -- windowed metric rollups (node-exporter-style samples) --------------------

#: 25 node-exporter metric families; each takes 8 instance suffixes, so
#: 200 metric names, and 8 hosts: 1,600 series
METRIC_BASES = [
    "node_cpu_seconds_total", "node_memory_MemAvailable_bytes",
    "node_memory_Cached_bytes", "node_filesystem_avail_bytes",
    "node_filesystem_files_free", "node_network_receive_bytes_total",
    "node_network_transmit_bytes_total", "node_network_receive_packets_total",
    "node_disk_read_bytes_total", "node_disk_written_bytes_total",
    "node_disk_io_time_seconds_total", "node_load1", "node_load5",
    "node_procs_running", "node_context_switches_total",
    "node_interrupts_total", "node_sockstat_TCP_inuse",
    "node_netstat_Tcp_RetransSegs", "node_entropy_available_bits",
    "node_pressure_cpu_waiting_seconds_total", "node_hwmon_temp_celsius",
    "node_power_supply_current_ampere", "node_vmstat_pgfault",
    "node_timex_offset_seconds", "node_hwmon_temp_offset_celsius",
]
#: families whose values are always negative (a clock behind, a sensor
#: below its reference), so their sums never cancel
METRIC_NEGATIVE = ("node_timex_offset_seconds",
                   "node_hwmon_temp_offset_celsius")
METRIC_HOSTS = [f"host-{i}" for i in range(8)]
#: event time of the first sample: 2025-10-09 08:53:20 UTC, a multiple of
#: the rollup window
METRICS_T0 = 1_760_000_000
METRICS_WINDOW = 10
METRICS_LATENESS = 5


def metric_names():
    return [f"{b}_{k}" for b in METRIC_BASES for k in range(8)]


def gen_metrics_jsonl(n, seed=0):
    """``n`` JSON lines of node-exporter-style samples, as bytes:
    ``{"time":"...","__name__":"...","host":"...","value":...}``, about 110
    bytes each.  Each of the 1,600 series (200 names x 8 hosts) is sampled
    once a second of event time, in event-time order, shuffled within each
    second.  Counters grow, gauges wander, and two families stay negative;
    values are decimals, about 1% in exponent form.  About 0.1% of the
    rows carry ``"value":"NaN"`` and about 0.1% have no ``__name__``:
    both are invalid rollup rows."""
    import time as _time
    rng = np.random.default_rng(seed)
    names = metric_names()
    series = [(nm, h) for nm in names for h in METRIC_HOSTS]
    S = len(series)
    kind = np.array([0 if nm.startswith(METRIC_NEGATIVE) else
                     1 if nm.endswith("_total") else 2
                     for nm, _ in series])
    start = 10.0 ** rng.uniform(0, 9, S)
    rate = 10.0 ** rng.uniform(-2, 5, S)
    level = 10.0 ** rng.uniform(-2, 6, S)
    neg = -rng.uniform(1, 90, S)
    seconds = -(-n // S)
    lines = []
    for t in range(seconds):
        ts = _time.strftime("%Y-%m-%d %H:%M:%S",
                            _time.gmtime(METRICS_T0 + t))
        noise = rng.uniform(0.9, 1.1, S)
        vals = np.where(kind == 1, start + rate * t * noise,
                        np.where(kind == 0, neg * noise, level * noise))
        order = rng.permutation(S)
        draw = rng.random(S)
        for i in order:
            if len(lines) == n:
                break
            nm, host = series[i]
            r = draw[i]
            if r < 0.001:
                val = '"NaN"'
            elif 0.002 <= r < 0.012:
                val = f"{vals[i]:.6e}"
            else:
                val = f"{vals[i]:.3f}"
            name = "" if 0.001 <= r < 0.002 else f'"__name__":"{nm}",'
            lines.append(f'{{"time":"{ts}",{name}"host":"{host}",'
                         f'"value":{val}}}'.encode())
    return lines


def metric_rollup_remote_write_config(log_path, endpoint,
                                      flusher=None):
    """The shipped ``metric_rollup_remote_write.yaml``, as YAML, with the
    changes of the rollup path and nothing else: ``FilePaths`` pointed at
    ``log_path``; ``processor_parse_timestamp_native`` on the JSON ``time``
    field (UTC), so windows come from event time and not from the second
    the file was read; ``Substrate: device``, so every fold is a segment
    reduce on the pipeline's device; and the shipped ``flusher_prometheus``
    with its ``Endpoint`` at ``endpoint``.  ``flusher`` (YAML of one
    flusher list entry) replaces the shipped sink."""
    sink = flusher or (f"""  - Type: flusher_prometheus
    Endpoint: {endpoint}
""")
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_parse_json_tpu
    SourceKey: content
  - Type: processor_parse_timestamp_native
    SourceKey: time
    SourceFormat: '%Y-%m-%d %H:%M:%S'
    SourceTimezone: 'GMT+00:00'
aggregators:
  - Type: aggregator_metric_rollup
    WindowSecs: {METRICS_WINDOW}
    AllowedLatenessSecs: {METRICS_LATENESS}
    MetricNameKey: __name__
    ValueKey: value
    LabelKeys: [host]
    MaxKeys: 65536
    Substrate: device
flushers:
{sink}"""


def metric_rollup_config(log_path, out_path):
    """``metric_rollup_remote_write_config`` with ``flusher_file`` in
    place of ``flusher_prometheus`` (no network)."""
    return metric_rollup_remote_write_config(
        log_path, None, flusher=f"""  - Type: flusher_file
    FilePath: {out_path}
""")


_METRIC_VALUE = re.compile(
    r"^[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|"
    r"[iI][nN][fF](?:[iI][nN][iI][tT][yY])?)$")


def _oracle_bucket(v, n_hist=41):
    """The rollup's log2 bucket of a value (base 1.0, the +Inf slot last)."""
    import math
    if math.isinf(v) and v > 0:
        return n_hist - 1
    if not v > 1.0:
        return 0
    m, e = math.frexp(v)
    return min(max(e - 1 if m == 0.5 else e, 0), n_hist - 1)


def metrics_oracle(lines, window=METRICS_WINDOW):
    """(rollups, invalid rows) of a ``gen_metrics_jsonl`` corpus by a plain
    f64 fold in row order, independent of the agent: rollups is {(window
    start, window end, name, host): {"sum", "count", "min", "max", "last",
    "hist": {bucket: count}}}.  A row is invalid without a name or with a
    value outside the rollup's grammar (a JSON string is its text)."""
    import calendar
    import json
    import time as _time
    out = {}
    invalid = 0
    epoch = {}
    for line in lines:
        obj = json.loads(line)
        name = obj.get("__name__")
        v = obj.get("value")
        if isinstance(v, str):
            tok = v.strip(" \t")
            v = float(tok) if _METRIC_VALUE.match(tok) else None
        elif v is not None:
            v = float(v)
        if name is None or v is None:
            invalid += 1
            continue
        ts = epoch.get(obj["time"])
        if ts is None:
            ts = epoch[obj["time"]] = calendar.timegm(
                _time.strptime(obj["time"], "%Y-%m-%d %H:%M:%S"))
        ws = ts // window * window
        key = (ws, ws + window, name, obj.get("host"))
        r = out.get(key)
        if r is None:
            r = out[key] = {"sum": 0.0, "count": 0, "min": v, "max": v,
                            "last": v, "hist": {}}
        r["sum"] += v
        r["count"] += 1
        r["min"] = min(r["min"], v)
        r["max"] = max(r["max"], v)
        r["last"] = v
        b = _oracle_bucket(v)
        r["hist"][b] = r["hist"].get(b, 0) + 1
    return out, invalid


_METRIC_VALUE_FIELD = re.compile(rb'"value":"?([^"}]*)"?}$')


def metrics_fold_rows(lines, chunk_size=512 * 1024, slide=METRICS_WINDOW):
    """The rollup's fold inputs on ``metric_rollup_config``'s path, rebuilt
    from a ``gen_metrics_jsonl`` corpus: one list of rows (name, (host,),
    value text, slot) for each group a one-shot read of ``lines`` (as a
    file) makes, i.e. each reader chunk of at most ``chunk_size`` bytes
    ending at a newline (``input/file/reader.py``), in row order.  The
    value text is the JSON value's (a string's without its quotes); a row
    without a name has no value, as the rollup forces it invalid; the slot
    is the event second over ``slide``.  ``testdata.pack_agg_rows`` turns
    a group into the fold's arguments."""
    import calendar
    import json
    import time as _time
    data = b"\n".join(lines) + b"\n"
    epoch = {}
    groups = []
    off = i = 0
    while off < len(data):
        piece = data[off:off + chunk_size]
        aligned = piece.rfind(b"\n") + 1
        k = piece.count(b"\n", 0, aligned)
        rows = []
        for line in lines[i:i + k]:
            obj = json.loads(line)
            ts = epoch.get(obj["time"])
            if ts is None:
                ts = epoch[obj["time"]] = calendar.timegm(
                    _time.strptime(obj["time"], "%Y-%m-%d %H:%M:%S"))
            name = obj.get("__name__")
            value = _METRIC_VALUE_FIELD.search(line).group(1)
            rows.append((None if name is None else name.encode(),
                         (obj["host"].encode(),),
                         None if name is None else value, ts // slide))
        groups.append(rows)
        off += aligned
        i += k
    return groups


def rollup_rows(ndjson):
    """The rollup rows of a sink's NDJSON bytes, keyed as
    ``metrics_oracle``'s; raises on a (window, series) emitted twice."""
    import json
    out = {}
    for line in ndjson.splitlines():
        if not line.strip():
            continue
        obj = json.loads(line)
        key = (int(obj["window_start"]), int(obj["window_end"]),
               obj.get("__name__"), obj.get("host"))
        if key in out:
            raise ValueError(f"rollup row emitted twice: {key}")
        hist = {}
        for part in obj.get("hist", "").split(","):
            if part:
                b, c = part.split(":")
                hist[int(b)] = int(c)
        out[key] = {"sum": float(obj["sum"]), "count": int(obj["count"]),
                    "min": float(obj["min"]), "max": float(obj["max"]),
                    "last": float(obj["last"]), "hist": hist}
    return out


ROLLUP_SAMPLE_FIELDS = ("sum", "count", "min", "max", "last")


def rollup_sample_rows(samples, window=METRICS_WINDOW):
    """The rollup rows of remote-write samples (``[(labels, value,
    timestamp ms)]``, ``flusher_prometheus``'s ``<name>_sum`` / ``_count``
    / ``_min`` / ``_max`` / ``_last`` at the window's end), keyed as
    ``metrics_oracle``'s and without histograms (remote write carries
    none); raises on a sample that arrived twice or a row that lacks one
    of its five samples."""
    rows = {}
    for labels, value, ts_ms in samples:
        name = labels["__name__"]
        field = next((f for f in ROLLUP_SAMPLE_FIELDS
                      if name.endswith("_" + f)), None)
        if field is None:
            raise ValueError(f"not a rollup sample: {name}")
        end = int(ts_ms) // 1000
        key = (end - window, end, name[:-len(field) - 1], labels.get("host"))
        row = rows.setdefault(key, {})
        if field in row:
            raise ValueError(f"sample arrived twice: {key} {field}")
        row[field] = int(value) if field == "count" else float(value)
    for key, row in rows.items():
        if len(row) != len(ROLLUP_SAMPLE_FIELDS):
            raise ValueError(f"rollup row {key} lacks samples: {row}")
    return rows


def rollup_mismatches(got, want, f32_want=False, tol=1e-5, limit=10):
    """Differences between two rollup row sets (``rollup_rows`` /
    ``metrics_oracle``, or ``rollup_sample_rows``, which carry no
    histograms): keys, counts and histograms exact, sums within
    ``rtol = atol = tol`` (the reference's device tolerance,
    ``scripts/agg_equivalence.py:163``), min, max and last equal, taking
    ``want``'s through f32 first when ``f32_want`` (a device fold against
    an f64 one).  At most ``limit`` descriptions."""
    import math
    bad = []
    for key in sorted(set(got) ^ set(want), key=repr)[:limit]:
        bad.append(f"{key}: only in {'got' if key in got else 'want'}")
    for key in sorted(set(got) & set(want)):
        if len(bad) >= limit:
            break
        g, w = got[key], want[key]
        if g["count"] != w["count"] or ("hist" in g and "hist" in w
                                        and g["hist"] != w["hist"]):
            bad.append(f"{key}: count/hist {g['count']} {g['hist']} != "
                       f"{w['count']} {w['hist']}")
            continue
        gs, ws = g["sum"], w["sum"]
        if not (gs == ws or (math.isnan(gs) and math.isnan(ws))
                or abs(gs - ws) <= tol + tol * abs(ws)):
            bad.append(f"{key}: sum {gs!r} != {ws!r}")
        for f in ("min", "max", "last"):
            wv = float(np.float32(w[f])) if f32_want else w[f]
            if g[f] != wv:
                bad.append(f"{key}: {f} {g[f]!r} != {wv!r}")
    return bad


def agg_batch_corpus():
    """The fold corpora of the JAX package's equivalence gate
    (``scripts/agg_equivalence.py:batch_corpus``), rebuilt here so the
    port's tests and ``chip_smoke.py`` need nothing of that package:
    [(label, rows, device_ok)] — rows are (name, labels tuple, value text,
    slot).  device_ok=False keeps f32-overflowing magnitudes out of the
    device comparison (documented f32 range)."""
    rng = np.random.default_rng(20260804)
    cases = []

    rows = [(b"reqs", (b"h1",), b"1", 0), (b"reqs", (b"h1",), b"2", 0),
            (b"reqs", (b"h2",), b"3.5", 0), (b"lat", (None,), b"0.25", 0),
            (b"reqs", (b"h1",), b"4", 1)]
    cases.append(("basic", rows, True))

    rows = [(b"m", (b"",), b"1", 0), (b"m", (None,), b"1", 0),
            (b"", (b"x",), b"2", 0), (b"m" * 61, (b"y" * 67,), b"3", 0),
            (b"ab", (b"",), b"5", 0), (b"a", (b"b",), b"5", 0)]
    cases.append(("absent-vs-empty keys, word-boundary lengths", rows, True))

    rows = [(b"v", (), b" 1.5 ", 0), (b"v", (), b"\t2e3\t", 0),
            (b"v", (), b"+.5", 0), (b"v", (), b"-0.0", 0),
            (b"v", (), b"1_0", 0), (b"v", (), b"0x10", 0),
            (b"v", (), b"nan", 0), (b"v", (), b"inf", 0),
            (b"v", (), b"-INF", 0), (b"v", (), b"Infinity", 0),
            (b"v", (), b"", 0), (b"v", (), b"  ", 0),
            (b"v", (), b"1e", 0), (b"v", (), b".", 0),
            (b"v", (), b"5.", 0), (b"v", (), b".5e-2", 0),
            (b"v", (), b"12345678901234567890", 0)]
    cases.append(("value grammar edge cases", rows, False))

    rows = [(b"big", (), b"1e300", 0), (b"big", (), b"1e300", 0),
            (b"tiny", (), b"1e-300", 0),
            (b"long", (), b"3." + b"1" * 120, 0)]
    cases.append(("magnitude extremes (host substrates only)", rows, False))

    names = [b"http_requests_total", b"cpu_seconds", b"gc_pause"]
    hosts = [b"h%d" % i for i in range(17)] + [None]
    rows = []
    for _ in range(3000):
        v = f"{rng.uniform(-100, 100):.6g}".encode()
        rows.append((names[rng.integers(len(names))],
                     (hosts[rng.integers(len(hosts))],
                      b"az%d" % rng.integers(3)),
                     v, int(rng.integers(0, 5))))
    cases.append(("random 3000x(3 names x 18 hosts x 3 az x 5 slots)",
                  rows, True))

    rows = [(b"one", (), b"%d" % i, i % 7) for i in range(257)]
    cases.append(("per-slot splits", rows, True))
    return cases


def pack_agg_rows(rows):
    """(arena, slots, key_offs, key_lens, val_offs, val_lens) of corpus
    rows: the fold's inputs (``scripts/agg_equivalence.py:pack_rows``)."""
    blob = bytearray()

    def put(b):
        if b is None:
            return (0, -1)
        off = len(blob)
        blob.extend(b)
        return (off, len(b))

    n = len(rows)
    K = 1 + max((len(r[1]) for r in rows), default=0)
    key_offs = np.zeros((n, K), np.int64)
    key_lens = np.full((n, K), -1, np.int32)
    val_offs = np.zeros(n, np.int64)
    val_lens = np.zeros(n, np.int32)
    slots = np.zeros(n, np.int64)
    for i, (nm, labels, v, slot) in enumerate(rows):
        key_offs[i, 0], key_lens[i, 0] = put(nm)
        for k, lb in enumerate(labels):
            key_offs[i, 1 + k], key_lens[i, 1 + k] = put(lb)
        val_offs[i], val_lens[i] = put(v)
        slots[i] = slot
    arena = (np.frombuffer(bytes(blob), np.uint8) if blob
             else np.zeros(0, np.uint8))
    return arena, slots, key_offs, key_lens, val_offs, val_lens


def k6_batch(seed, B, G, n_hist, invalid=0.0, hot=False, inf=False,
             n_real=None, spread=False):
    """One segment-reduce batch (K6's inputs) as numpy: values f32,
    segment ids i32, bucket ids i32 and valid bool, each ``[B]``.  Rows
    take segments in ``[0, G)``; ``invalid`` of them are not valid, the
    rows from ``n_real`` on (by default the last eighth) are padding
    (segment ``G``, not valid, as the fold pads); ``hot`` sends nine rows
    in ten to segment 3 (atomic contention); ``inf`` plants +inf, -inf and
    both zeros.

    Values are sixteenths below 16 in magnitude, so every partial sum of
    up to 65536 of them is exact in f32 and the sums agree in any order of
    addition; with ``spread`` they are positive and spread over nine
    decades (10^-2 .. 10^7), where the order of the f32 adds shows."""
    rng = np.random.default_rng(seed)
    if spread:
        vals = (10.0 ** rng.uniform(-2, 7, B)).astype(np.float32)
    else:
        vals = (rng.integers(-255, 256, B) / 16.0).astype(np.float32)
    if inf:
        k = rng.permutation(B)[:max(8, B // 64)]
        q = len(k) // 4
        vals[k[:q]] = np.inf
        vals[k[q:2 * q]] = -np.inf
        vals[k[2 * q:3 * q]] = -0.0
        vals[k[3 * q:]] = 0.0
    seg = rng.integers(0, G, B).astype(np.int32)
    if hot:
        seg[rng.random(B) < 0.9] = min(3, G - 1)
    buckets = rng.integers(0, n_hist, B).astype(np.int32)
    valid = rng.random(B) >= invalid
    pad = B - B // 8 if n_real is None else n_real
    seg[pad:] = G
    valid[pad:] = False
    buckets[pad:] = 0
    return vals, seg, buckets, valid


def k6_cases(max_rows=65536):
    """(label, B, G, n_hist, invalid, hot, inf, spread) of the K6 parity
    batches: B from 256 up to ``max_rows``, G from 16 to B, 41 or 1
    buckets, invalid shares of 0, 10% and 100%, a hot segment, +-inf, and
    spread values where segments hold at most 64 rows on average (so the
    f32 sums of two orders stay well inside rtol = 1e-5)."""
    cases = []
    for B in (256, 2048, 8192, 65536):
        if B > max_rows:
            continue
        for G in sorted({16, 2048, B}):
            if G > B:
                continue
            kinds = [(0.0, False, False, False), (0.1, False, True, False),
                     (1.0, False, False, False), (0.0, True, True, False)]
            if B // G <= 64:
                kinds.append((0.1, False, False, True))
            for n_hist in (41, 1):
                for invalid, hot, inf, spread in kinds:
                    cases.append((f"B{B}_G{G}_h{n_hist}_inv{invalid}"
                                  f"{'_hot' if hot else ''}"
                                  f"{'_inf' if inf else ''}"
                                  f"{'_spread' if spread else ''}",
                                  B, G, n_hist, invalid, hot, inf, spread))
    return cases


def k6_edge_segments(G, R):
    """Segment ids on either side of each owner boundary of blocks that
    own ``R`` segments each (``k R - 1``, ``k R``, ``k R + 1``), the first
    and last segment, and ids outside ``[0, G)`` (-1, ``G``, ``G + 7``)."""
    ids = {0, G - 1, -1, G, G + 7}
    for k in range(1, -(-G // R)):
        ids |= {k * R - 1, k * R, k * R + 1}
    return np.array(sorted(ids), np.int32)


K6_EDGE_KINDS = ("mixed", "hot_all", "boundaries", "empty")


def k6_edge_batch(kind, seed, B, G, n_hist, R):
    """One K6 batch of an edge kind (``K6_EDGE_KINDS``) for a cluster
    whose blocks own ``R`` segments each: ``mixed`` rows over every
    segment with a tenth invalid and a few segments and buckets out of
    range; ``hot_all`` every valid row in one segment; ``boundaries`` every
    row on a segment of ``k6_edge_segments`` (so the others stay empty),
    buckets -1 and ``n_hist`` among them; ``empty`` no valid row.  Values
    are sixteenths below 16 (exact f32 sums in any order)."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-255, 256, B) / 16.0).astype(np.float32)
    seg = rng.integers(0, G, B).astype(np.int32)
    buckets = rng.integers(0, n_hist, B).astype(np.int32)
    valid = rng.random(B) >= 0.1
    if kind == "mixed":
        k = rng.permutation(B)[:B // 50]
        seg[k[:len(k) // 2]] = rng.choice([-1, G, G + 3], len(k) // 2)
        buckets[k[len(k) // 2:]] = rng.choice([-1, n_hist], len(k) - len(k)
                                              // 2)
    elif kind == "hot_all":
        seg[:] = G // 2
        valid[:] = True
    elif kind == "boundaries":
        seg = rng.choice(k6_edge_segments(G, R), B).astype(np.int32)
        k = rng.permutation(B)[:B // 20]
        buckets[k] = rng.choice([-1, n_hist], len(k))
    elif kind == "empty":
        valid[:] = False
    else:
        raise ValueError(f"no K6 edge kind {kind!r}")
    return vals, seg, buckets, valid


# -- the structural-index slice: quote-mode CSV, pipe-delimited, JSON ---------

CSV_KEYS = ["time", "client", "method", "url", "status", "bytes",
            "user_agent", "request_id"]
_CSV_PATHS = ["/api/v1/items", "/api/v2/orders", "/search", "/static/app.js",
              "/login", "/cart/checkout", "/reports/export"]
_CSV_AGENTS = [
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko) "
    "Chrome/124.0 Safari/537.36",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 14_4) AppleWebKit/605.1.15 "
    "(KHTML, like Gecko) Version/17.4 Safari/605.1.15",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64; rv:125.0) Gecko/20100101 "
    "Firefox/125.0",
    "curl/8.5.0, libcurl/8.5.0 (x86_64-pc-linux-gnu)",
]


def gen_quoted_csv(n, seed=0):
    """``n`` quote-mode CSV lines of an HTTP audit log, as bytes, about
    200-250 bytes each, eight fields (``CSV_KEYS``): the URL and the user
    agent are quoted and hold commas.  About 1% of the rows carry doubled
    quotes (``""``) inside the quoted agent, about 0.1% lose the closing
    quote of the URL (an unbalanced quote)."""
    rng = np.random.default_rng(seed)
    methods = ["GET", "POST", "PUT", "DELETE"]
    statuses = [200, 200, 200, 201, 204, 301, 404, 500]
    r = rng.random(n)
    path = rng.integers(len(_CSV_PATHS), size=n)
    ids = rng.integers(1, 999, size=(n, 3))
    page = rng.integers(1, 50, size=n)
    agent = rng.integers(len(_CSV_AGENTS), size=n)
    ip = rng.integers(0, 256, size=(n, 3))
    method = rng.integers(len(methods), size=n)
    status = rng.integers(len(statuses), size=n)
    size = rng.integers(0, 10 ** 6, size=n)
    lines = []
    for i in range(n):
        url = (f"{_CSV_PATHS[path[i]]}?ids={ids[i, 0]},{ids[i, 1]},"
               f"{ids[i, 2]}&sort=asc&lang=en-US&page={page[i]}")
        ua = _CSV_AGENTS[agent[i]]
        if r[i] < 0.01:
            ua = ua.replace("(KHTML", '""build 7"", (KHTML') \
                if "KHTML" in ua else ua + ' ""beta""'
        url_f = f'"{url}' if 0.01 <= r[i] < 0.011 else f'"{url}"'
        lines.append(
            (f"2024-05-01T{(i // 3600) % 24:02d}:{(i // 60) % 60:02d}:"
             f"{i % 60:02d}.{i % 1000:03d}Z,10.{ip[i, 0]}.{ip[i, 1]}."
             f"{ip[i, 2] or 1},{methods[method[i]]},{url_f},"
             f"{statuses[status[i]]},{size[i]},\"{ua}\","
             f"req-{i:08d}").encode())
    return lines


def quoted_csv_config(log_path, out_path):
    """The quote-mode CSV config, as YAML: ``input_file``,
    ``processor_parse_delimiter_native`` (``Mode: quote``, ``Separator:
    ","``, ``CSV_KEYS``), ``flusher_file``."""
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_parse_delimiter_native
    SourceKey: content
    Separator: ","
    Mode: quote
    Keys: [{", ".join(CSV_KEYS)}]
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def csv_oracle(lines, keys=CSV_KEYS, sep=b","):
    """Each line's record as the quote-mode parse gives it, in order: the
    reference FSM's fields (``_csv_fsm_split``), the tail fields joined
    into the last key; a line with fewer fields than keys keeps only
    ``rawLog``."""
    from .processor.parse_delimiter import _csv_fsm_split
    F = len(keys)
    out = []
    for line in lines:
        fields = _csv_fsm_split(line, sep)
        if len(fields) < F:
            out.append({"rawLog": line.decode()})
            continue
        if len(fields) > F:
            fields = fields[:F - 1] + [sep.join(fields[F - 1:])]
        out.append({k: v.decode() for k, v in zip(keys, fields)})
    return out


def csv_deviant(line, F=len(CSV_KEYS), sep=0x2C, quote=0x22):
    """True when the index tier cannot emit the row from its masks: an odd
    count of quotes, a quote that is not at a field's edge (the row's ends
    or next to a separator outside quotes), or more fields than ``F``.
    A per-row walk, written apart from the masks it checks."""
    inside = False
    seps = []
    quotes = []
    for i, b in enumerate(line):
        if b == quote:
            inside = not inside
            quotes.append(i)
        elif b == sep and not inside:
            seps.append(i)
    if len(quotes) % 2 or len(seps) + 1 > F:
        return True
    edge = set(seps)
    return any(not (i == 0 or i == len(line) - 1 or i - 1 in edge
                    or i + 1 in edge) for i in quotes)


PIPE_KEYS = ["time", "level", "service", "host", "latency_ms", "msg"]
PIPE_INCLUDE = {"level": "ERROR|WARN"}
PIPE_EXCLUDE = {"service": "healthcheck"}
_PIPE_SERVICES = ["checkout", "payments", "search", "healthcheck", "auth",
                  "inventory"]
_PIPE_MSGS = ["request served", "upstream timeout after {n} ms",
              "cache miss for key user:{n}", "retrying call {n}",
              "queue depth {n} | over soft limit", "connection reset by peer"]


def gen_pipe_log(n, seed=0):
    """``n`` pipe-delimited service log lines, as bytes:
    ``time|level|service|host|latency_ms|msg``; a message may hold a ``|``
    (the last field takes the rest), and about 0.1% of the lines have too
    few fields."""
    rng = np.random.default_rng(seed)
    levels = ["INFO"] * 14 + ["DEBUG"] * 2 + ["WARN"] * 2 + ["ERROR"] * 2
    msg = rng.integers(len(_PIPE_MSGS), size=n)
    num = rng.integers(1, 10 ** 5, size=n)
    lvl = rng.integers(len(levels), size=n)
    svc = rng.integers(len(_PIPE_SERVICES), size=n)
    node = rng.integers(64, size=n)
    lat = rng.integers(0, 5000, size=n)
    short = rng.random(n) < 0.001
    lines = []
    for i in range(n):
        line = (f"2024-05-01T{(i // 3600) % 24:02d}:{(i // 60) % 60:02d}:"
                f"{i % 60:02d}.{i % 1000:03d}Z|{levels[lvl[i]]}|"
                f"{_PIPE_SERVICES[svc[i]]}|node-{node[i]:02d}|{lat[i]}|"
                + _PIPE_MSGS[msg[i]].format(n=num[i]))
        if short[i]:
            line = line.rsplit("|", 3)[0]
        lines.append(line.encode())
    return lines


def pipe_filter_config(log_path, out_path):
    """The delimiter-then-filter config, as YAML: ``input_file``,
    ``processor_parse_delimiter_native`` (``|``, ``PIPE_KEYS``, non-quote),
    ``processor_filter_native`` keeping ``level`` ERROR or WARN and dropping
    ``service`` healthcheck, ``flusher_file``."""
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_parse_delimiter_native
    SourceKey: content
    Separator: "|"
    Keys: [{", ".join(PIPE_KEYS)}]
  - Type: processor_filter_native
    Include:
      level: '{PIPE_INCLUDE["level"]}'
    Exclude:
      service: '{PIPE_EXCLUDE["service"]}'
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def pipe_filter_oracle(lines):
    """The fields of the lines the delimiter-filter path keeps, in order:
    ``split`` into the six keys (the last takes the rest; fewer fields
    fail the parse and have no level), then ``re.fullmatch`` of the
    Include and Exclude."""
    inc = re.compile(PIPE_INCLUDE["level"].encode())
    exc = re.compile(PIPE_EXCLUDE["service"].encode())
    lvl, svc = PIPE_KEYS.index("level"), PIPE_KEYS.index("service")
    out = []
    for line in lines:
        fields = line.split(b"|", len(PIPE_KEYS) - 1)
        if len(fields) < len(PIPE_KEYS) or not inc.fullmatch(fields[lvl]) \
                or exc.fullmatch(fields[svc]):
            continue
        out.append({k: v.decode() for k, v in zip(PIPE_KEYS, fields)})
    return out


JSON_FILTER_LEVEL = "ERROR|WARN"


def gen_json_events(n, seed=0):
    """``n`` structured JSON events of about 1 KB, as bytes: a flat object
    of strings and integers (time, level, service, host, trace and span
    ids, HTTP fields, a message with escapes, and a long attributes
    string).  ``level`` is INFO 70%, DEBUG 10%, WARN 12%, ERROR 8%."""
    import json as _json
    rng = np.random.default_rng(seed)
    levels = np.array(["INFO", "DEBUG", "WARN", "ERROR"])
    lvl = levels[np.searchsorted([0.7, 0.8, 0.92], rng.random(n),
                                 side="right")]
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
             "hotel", "india", "juliet", "kilo", "lima"]
    # attribute strings of 54 pairs, from a seeded pool of pairs
    pairs = [f"{words[w]}={v}" for w, v in zip(
        rng.integers(12, size=4096), rng.integers(10 ** 6, size=4096))]
    pick = rng.integers(4096, size=(n, 54))
    service = rng.integers(6, size=n)
    host = rng.integers(64, size=n)
    ids = rng.integers(2 ** 62, size=(n, 2))
    method = rng.integers(3, size=n)
    path = rng.integers(len(_CSV_PATHS), size=n)
    status = rng.choice([200, 201, 404, 500, 503], size=n)
    nums = rng.integers(0, 10 ** 6, size=(n, 3))
    word = rng.integers(12, size=n)
    lines = []
    for i in range(n):
        ev = {
            "time": f"2024-05-01T{(i // 3600) % 24:02d}:"
                    f"{(i // 60) % 60:02d}:{i % 60:02d}.{i % 1000:03d}Z",
            "level": str(lvl[i]),
            "service": _PIPE_SERVICES[service[i]],
            "host": f"node-{host[i]:02d}",
            "trace_id": f"{ids[i, 0]:032x}",
            "span_id": f"{ids[i, 1]:016x}",
            "method": ["GET", "POST", "PUT"][method[i]],
            "path": _CSV_PATHS[path[i]],
            "status": int(status[i]),
            "latency_ms": int(nums[i, 0] % 5000),
            "bytes": int(nums[i, 1]),
            "msg": f"call \"{words[word[i]]}\" done\tin "
                   f"{nums[i, 2] % 1000} ms\nretry=0",
            "attrs": ";".join(pairs[j] for j in pick[i]),
        }
        lines.append(_json.dumps(ev, separators=(",", ":")).encode())
    return lines


def json_filter_config(log_path, out_path):
    """The shipped ``example_config/quick_start/json_filter.yaml``
    (``BASELINE.json`` config 4), as YAML, with its FilePaths pointed at
    ``log_path`` and ``flusher_file`` in place of ``flusher_stdout``."""
    import os as _os
    src = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), "example_config", "quick_start",
        "json_filter.yaml")
    with open(src) as f:
        text = f.read()
    text = text.replace("/tmp/loongcollector_demo/events.json", log_path)
    text = text.replace("  - Type: flusher_stdout",
                        f"  - Type: flusher_file\n    FilePath: {out_path}")
    if log_path not in text or out_path not in text:
        raise ValueError("json_filter.yaml no longer has the expected "
                         "FilePaths or flusher")
    return text


def json_filter_oracle(lines):
    """The events the JSON-filter path keeps, in order, as ``json.loads``
    gives them with every value as the text the parse keeps (strings
    decoded, integers in their source spelling)."""
    import json as _json
    inc = re.compile(JSON_FILTER_LEVEL)
    out = []
    for line in lines:
        ev = _json.loads(line)
        if isinstance(ev.get("level"), str) and inc.fullmatch(ev["level"]):
            out.append({k: v if isinstance(v, str) else str(v)
                        for k, v in ev.items()})
    return out


def struct_stage_lists():
    """The stage lists K7's ``struct_index`` stage is held to, as (name,
    specs, rows) like ``fused_stage_lists``: ``struct_json`` (one JSON-mode
    stage), ``struct_delim`` (one delimiter-mode stage, ``,``) and
    ``delim_struct_keep`` (the pipe delimiter's Tier-1 program, a
    delimiter-mode index on ``|``, and the delimiter-filter path's keep on
    the level and service captures).  No planner emits such a stage: these
    lists are built here, as the reference's tests build theirs."""
    from .ops import fused_pipeline as fp
    from .ops.kernels.dfa_scan import LazySpanMatchKernel
    from .ops.kernels.field_extract import ExtractKernel
    from .ops.kernels.struct_index import MODE_DELIM, MODE_JSON
    from .ops.regex.dfa import compile_dfa
    from .ops.regex.program import compile_tier1

    def struct(mode, sep):
        return fp.StageSpec("struct_index", (mode, sep),
                            ["struct_index", mode, sep])

    def span(pattern, prod, cap, negate=False):
        dfa = compile_dfa(pattern)
        return fp.StageCond("span_match", dfa,
                            ["span_match", pattern, prod, cap, negate],
                            binding=(prod, cap), negate=negate,
                            staged=LazySpanMatchKernel(dfa))

    kern = ExtractKernel(compile_tier1(PIPE_PATTERN))
    lvl, svc = PIPE_KEYS.index("level"), PIPE_KEYS.index("service")
    keep_conds = [span(PIPE_INCLUDE["level"], 0, lvl),
                  span(PIPE_EXCLUDE["service"], 0, svc, negate=True)]
    return [
        ("struct_json", [struct(MODE_JSON, 0x2C)], _json_struct_rows),
        ("struct_delim", [struct(MODE_DELIM, 0x2C)], _csv_struct_rows),
        ("delim_struct_keep",
         [fp.StageSpec("extract", kern.program, ["extract", PIPE_PATTERN],
                       staged=kern),
          struct(MODE_DELIM, 0x7C),
          fp.StageSpec("keep", keep_conds,
                       ["keep"] + [list(c.ident) for c in keep_conds])],
         _pipe_struct_rows),
    ]


#: the pipe delimiter's Tier-1 program, as processor_parse_delimiter
#: derives it for six keys
PIPE_PATTERN = r"\|".join([r"([^\|]*)"] * 5 + ["(.*)"])


def struct_adversarial_rows():
    """The reference's adversarial rows of the structural index
    (``tests/test_struct_index.py:110-125``): escapes, unterminated
    strings, doubled quotes, backslash runs of 1-9 ending at bytes 54-63,
    and 250 seeded rows over ``ab\\",{}[]: \\t``."""
    rows = [b'{"a": "b"}', b'', b'{}', b'\\"x', b'"unterm',
            b'a,b,"c,d",e', b'"a""b",c',
            b'{"k": "v\\nw", "n": [1, {"m": "x,y"}]}']
    for k in range(1, 10):
        rows.append(b'x' * (63 - k) + b'\\' * k + b'n"q"')
        rows.append(b'{"e": "' + b'x' * (55 - k) + b'\\' * k + b'n"}')
    rng = np.random.default_rng(21)
    for _ in range(250):
        L = int(rng.integers(0, 150))
        rows.append(bytes(rng.choice(
            list(b'ab\\",{}[]: \t'), size=L).astype(np.uint8)))
    return rows


def _json_struct_rows(rng, n, L):
    pool = struct_adversarial_rows() + gen_json_events(
        20, seed=int(rng.integers(1000)))
    pool += [b'"' + b'\\' * k + b'"' * 3 for k in range(40)]
    return _fit(rng, pool, n, L)


def _csv_struct_rows(rng, n, L):
    pool = struct_adversarial_rows() + gen_quoted_csv(
        200, seed=int(rng.integers(1000)))
    return _fit(rng, pool, n, L)


def _pipe_struct_rows(rng, n, L):
    pool = gen_pipe_log(300, seed=int(rng.integers(1000)))
    pool += [b'a|"b|c"|d', b'"|"|x|y|z|w', b'||||||', b'x|y']
    return _fit(rng, pool, n, L)


def reader_chunks(lines, chunk_size=512 * 1024):
    """The lines of each group a one-shot read of ``lines`` (as a file)
    makes: each reader chunk of at most ``chunk_size`` bytes ending at a
    newline (``input/file/reader.py``), in order."""
    data = b"\n".join(lines) + b"\n"
    groups = []
    off = i = 0
    while off < len(data):
        piece = data[off:off + chunk_size]
        aligned = piece.rfind(b"\n") + 1
        k = piece.count(b"\n", 0, aligned)
        groups.append(lines[i:i + k])
        off += aligned
        i += k
    return groups


# -- URL classification (BASELINE.json config 5) -----------------------------

# (category, regex) in rule order: the first rule that fully matches wins
URL_RULES = [("api", r"/api/v1/.*|/api/v2/orders/\d+"),
             ("static", r"/static/.*|.*\.(?:js|css)"),
             ("health", r"/health")]
URL_DEFAULT = "other"
URL_DROP = r"/favicon\.ico"


def url_classify_config(log_path, out_path):
    """The URL-classified Apache path, as YAML: ``input_file``,
    ``processor_parse_regex_native`` with the shipped Apache pattern and
    keys (``file_regex_apache.yaml``), ``processor_drop`` of the
    ``/favicon.ico`` urls, ``processor_classify_url_tpu`` of the url into
    ``category`` by ``URL_RULES``, ``flusher_file``."""
    keys = ", ".join(APACHE_KEYS)
    rules = "".join(f"      - Name: {name}\n        Regex: '{rx}'\n"
                    for name, rx in URL_RULES)
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_parse_regex_native
    SourceKey: content
    Regex: '{APACHE}'
    Keys: [{keys}]
  - Type: processor_drop
    Match:
      url: '{URL_DROP}'
  - Type: processor_classify_url_tpu
    SourceKey: url
    TargetKey: category
    DefaultCategory: {URL_DEFAULT}
    Rules:
{rules}flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def url_category(path, rules=None):
    """The category the first fully matching rule gives ``path`` (bytes),
    or ``URL_DEFAULT``."""
    for name, rx in rules or _url_rules_re():
        if rx.fullmatch(path):
            return name
    return URL_DEFAULT


def _url_rules_re():
    return [(name, re.compile(rx.encode())) for name, rx in URL_RULES]


def url_classify_oracle(lines):
    """The records of the URL-classified Apache path (but ``__time__``),
    in file order: ``re.fullmatch`` of the Apache pattern (a line that
    fails it keeps its text under ``rawLog``, with no url to drop or
    classify), the ``/favicon.ico`` urls dropped, and the category of the
    first rule that fully matches the url."""
    rx = re.compile(APACHE.encode())
    drop = re.compile(URL_DROP.encode())
    rules = _url_rules_re()
    url = APACHE_KEYS.index("url")
    out = []
    for line in lines:
        m = rx.fullmatch(line)
        if m is None:
            out.append({"rawLog": line.decode()})
            continue
        if drop.fullmatch(m.group(url + 1)):
            continue
        rec = {k: v.decode() for k, v in zip(APACHE_KEYS, m.groups())}
        rec["category"] = url_category(m.group(url + 1), rules)
        out.append(rec)
    return out


# -- the eBPF network observer's event stream --------------------------------

EBPF_BINARIES = ["/usr/sbin/nginx", "/usr/bin/python3", "/usr/bin/java",
                 "/usr/bin/node", "/usr/local/bin/envoy", "/usr/bin/ruby",
                 "/usr/sbin/php-fpm", "/usr/bin/gunicorn"]
EBPF_T0_NS = 1_700_000_000 * 1_000_000_000
# the mix of exchanges: HTTP, Redis, MySQL
EBPF_MIX = (0.8, 0.1, 0.1)
_REMOTES = {"http": (80, 8), "redis": (6379, 4), "mysql": (3306, 4)}
_HTTP_METHODS = ["GET", "GET", "GET", "POST", "PUT", "DELETE"]
_REDIS_KEYS = [f"session:{i}" for i in range(40)] + ["cart:7", "rate:ip"]
_SQL = ["select * from orders where id = {n}",
        "select name, price from items where sku = 'k{n}' limit 20",
        "update users set last_seen = now() where id = {n}",
        "insert into audit (uid, action) values ({n}, 'login')"]
# first bytes a payload may not start with: HTTP or RESP would take it
_RESP_MARKERS = frozenset(b"*+-:$")


def _http_exchange(rng):
    method = _HTTP_METHODS[int(rng.integers(len(_HTTP_METHODS)))]
    path = APACHE_PATHS[int(rng.integers(len(APACHE_PATHS)))]
    host = f"shop-{int(rng.integers(4))}.example"
    req = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
           f"User-Agent: loong-load/1.0\r\nAccept: */*\r\n\r\n").encode()
    u = rng.random()
    status, reason = ((503, "Service Unavailable") if u < 0.025 else
                      (500, "Internal Server Error") if u < 0.05 else
                      (404, "Not Found") if u < 0.10 else (200, "OK"))
    body = b"x" * int(rng.integers(0, 96))
    resp = (f"HTTP/1.1 {status} {reason}\r\nContent-Type: text/html\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    span = {"name": f"{method} {path}", "status_code": str(status),
            "error": status >= 400}
    return req, resp, span, path.encode()


def _redis_exchange(rng):
    key = _REDIS_KEYS[int(rng.integers(len(_REDIS_KEYS)))].encode()
    u = rng.random()
    if u < 0.5:
        val = b"v" * int(rng.integers(1, 40))
        req = (b"*3\r\n$3\r\nSET\r\n$%d\r\n%s\r\n$%d\r\n%s\r\n"
               % (len(key), key, len(val), val))
        resp, cmd, err = b"+OK\r\n", "SET", False
    elif u < 0.97:
        req = b"*2\r\n$3\r\nGET\r\n$%d\r\n%s\r\n" % (len(key), key)
        val = b"h" * int(rng.integers(1, 60))
        resp, cmd, err = b"$%d\r\n%s\r\n" % (len(val), val), "GET", False
    else:
        req = b"*2\r\n$4\r\nINCR\r\n$%d\r\n%s\r\n" % (len(key), key)
        resp = b"-ERR value is not an integer or out of range\r\n"
        cmd, err = "INCR", True
    return req, resp, {"name": cmd, "status_code": "", "error": err}, None


def _mysql_packet(seq, body):
    n = len(body)
    return bytes([n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF, seq]) + body


def _mysql_exchange(rng):
    while True:
        sql = _SQL[int(rng.integers(len(_SQL)))].format(
            n=int(rng.integers(1, 10**6))).encode()
        if (len(sql) + 1) & 0xFF not in _RESP_MARKERS:
            break
    req = _mysql_packet(0, b"\x03" + sql)
    u = rng.random()
    code = ""
    if u < 0.03:
        msg = b"#42S02Table 'shop.order' doesn't exist"
        resp = _mysql_packet(1, b"\xff" + (1146).to_bytes(2, "little") + msg)
        code = "1146"
    elif sql.startswith(b"select"):
        resp = _mysql_packet(1, bytes([int(rng.integers(1, 9))]))
    else:
        resp = _mysql_packet(1, b"\x00\x01\x00\x02\x00\x00\x00")
    return req, resp, {"name": "QUERY", "status_code": code,
                       "error": bool(code)}, None


_EXCHANGES = {"http": _http_exchange, "redis": _redis_exchange,
              "mysql": _mysql_exchange}


def ebpf_stream(seed, n_exchanges, n_procs=64, n_conns=256):
    """The raw-event stream of the eBPF phase and what the observer must
    make of it.

    ``n_procs`` processes exec (``process_security`` ``sys_execve``
    events: binary in ``path``, arguments in ``payload``), then
    ``n_conns`` client connections (``conn_connect`` ... ``conn_close``),
    each owned by one process and speaking one protocol (``EBPF_MIX`` of
    the connections), carry ``n_exchanges`` request/response exchanges,
    one at a time a connection, in timestamp order across connections.

    Returns ``(events, expected)``: ``events`` a list of keyword dicts of
    ``RawKernelEvent`` (``source`` as the ``EventSource`` value string),
    in delivery order; ``expected`` holds the exec'd processes (pid →
    comm), the count of payload events, the HTTP request paths, the
    completed exchanges as spans (name, status code, latency) and the
    rollup cells per (protocol, remote, status) with their count, errors,
    latency sum and largest latency, and bytes received and sent."""
    rng = np.random.default_rng(seed)
    procs = []
    events = []
    for i in range(n_procs):
        binary = EBPF_BINARIES[i % len(EBPF_BINARIES)]
        pid, ktime = 20_000 + 17 * i, 5_000_000 + 1_000 * i
        args = f"{binary.rsplit('/', 1)[-1]} --worker {i}"
        procs.append((pid, ktime, binary.rsplit("/", 1)[-1]))
        events.append(dict(source="process_security", pid=pid, ppid=1,
                           ktime=ktime, timestamp_ns=EBPF_T0_NS + i,
                           call_name="sys_execve", path=binary,
                           payload=args.encode()))
    n_http = round(n_conns * EBPF_MIX[0])
    n_redis = round(n_conns * EBPF_MIX[1])
    protos = (["http"] * n_http + ["redis"] * n_redis
              + ["mysql"] * (n_conns - n_http - n_redis))
    conns = []
    for j, proto in enumerate(protos):
        pid, ktime, _comm = procs[j % n_procs]
        port, n_remote = _REMOTES[proto]
        pidx = ("http", "redis", "mysql").index(proto)
        conns.append(dict(pid=pid, ktime=ktime, fd=100 + j, proto=proto,
                          local=f"10.0.{j // 250}.{j % 250 + 1}:"
                                f"{40_000 + j}",
                          remote=f"10.9.{pidx}.{j % n_remote + 1}:{port}"))
    by_proto = {p: [c for c in conns if c["proto"] == p]
                for p in ("http", "redis", "mysql")}
    # each exchange's protocol by EBPF_MIX, then one connection of it
    kinds = rng.choice(3, size=n_exchanges, p=list(EBPF_MIX))
    plan = [[] for _ in conns]
    for k in kinds:
        pool = by_proto[("http", "redis", "mysql")[int(k)]]
        c = pool[int(rng.integers(len(pool)))]
        plan[c["fd"] - 100].append(c)
    timed = []      # (ts, seq, event); seq keeps a connection's order
    seq = 0
    spans, cells, paths = [], {}, {}
    for j, c in enumerate(conns):
        base = dict(source="network_observe", pid=c["pid"], fd=c["fd"],
                    ktime=c["ktime"], local_addr=c["local"],
                    remote_addr=c["remote"])
        t = EBPF_T0_NS + 1_000_000 + int(rng.integers(0, 50_000_000))
        timed.append((t, seq, dict(base, call_name="conn_connect",
                                   timestamp_ns=t)))
        seq += 1
        rx = tx = 0
        for _ in plan[j]:
            req, resp, span, path = _EXCHANGES[c["proto"]](rng)
            t += int(rng.integers(10_000, 2_000_000))
            lat = int(rng.integers(50_000, 20_000_000))
            timed.append((t, seq, dict(base, direction="egress",
                                       payload=req, timestamp_ns=t)))
            timed.append((t + lat, seq + 1, dict(
                base, direction="ingress", payload=resp,
                timestamp_ns=t + lat)))
            seq += 2
            t += lat
            tx += len(req)
            rx += len(resp)
            if path is not None:
                paths[path] = paths.get(path, 0) + 1
            spans.append((span["name"], span["status_code"], lat))
            status = (span["status_code"][:1] + "xx" if span["status_code"]
                      else ("error" if span["error"] else "ok"))
            cell = cells.setdefault((c["proto"], c["remote"], status), {
                "count": 0, "errors": 0, "latency_sum_ns": 0,
                "latency_max_ns": 0, "rx_bytes": 0, "tx_bytes": 0})
            cell["count"] += 1
            cell["errors"] += span["error"]
            cell["latency_sum_ns"] += lat
            cell["latency_max_ns"] = max(cell["latency_max_ns"], lat)
            cell["rx_bytes"] += rx
            cell["tx_bytes"] += tx
            rx = tx = 0
        t += 1_000
        timed.append((t, seq, dict(base, call_name="conn_close",
                                   timestamp_ns=t)))
        seq += 1
    timed.sort(key=lambda e: (e[0], e[1]))
    events.extend(e for _t, _s, e in timed)
    expected = {
        "procs": {pid: comm for pid, _k, comm in procs},
        "payload_events": 2 * n_exchanges,
        "http_paths": paths,
        "spans": sorted(spans),
        "cells": cells,
    }
    return events, expected


def ebpf_mismatches(net_records, sec_records, expected, limit=10):
    """What the observer's NDJSON records (``flusher_file`` of the network
    observer's pipeline, ``net_records``, and of the process-security
    pipeline, ``sec_records``) get wrong against ``ebpf_stream``'s
    ``expected``, as messages (empty when they agree): one log record a
    payload event, ``comm`` from the exec'd process, each HTTP request's
    ``category`` by ``URL_RULES`` and no category on any other record,
    the request paths, the spans' names and latencies, and the
    ``ebpf_l7_requests`` cells summed per (protocol, remote, status)."""
    bad = []
    procs = {str(pid): comm for pid, comm in expected["procs"].items()}
    execs = {r.get("pid"): r.get("comm") for r in sec_records
             if r.get("call_name") == "sys_execve"}
    if execs != procs:
        bad.append(f"exec records: {len(execs)} processes, want "
                   f"{len(procs)}; first differing: "
                   f"{sorted(set(execs.items()) ^ set(procs.items()))[:3]}")
    logs, spans, cells = [], [], {}
    for r in net_records:
        if "spanId" in r:
            spans.append((r["name"], r["endTimeNs"] - r["startTimeNs"]))
        elif r.get("__name__") == "ebpf_l7_requests":
            lab = r["__labels__"]
            key = (lab["protocol"], lab["remote"], lab["status"])
            cell = cells.setdefault(key, dict.fromkeys(
                ("count", "errors", "latency_sum_ns", "latency_max_ns",
                 "rx_bytes", "tx_bytes"), 0))
            for k, v in r["__values__"].items():
                cell[k] = (max(cell[k], int(v)) if k == "latency_max_ns"
                           else cell[k] + int(v))
        else:
            logs.append(r)
    if len(logs) != expected["payload_events"]:
        bad.append(f"{len(logs)} log records, want "
                   f"{expected['payload_events']} (one a payload event)")
    rules = _url_rules_re()
    paths = {}
    for r in logs:
        if r.get("comm") != procs.get(r.get("pid")):
            bad.append(f"comm {r.get('comm')!r} for pid {r.get('pid')}")
        if r.get("protocol") == "http" and r.get("kind") == "request":
            path = r["path"].encode()
            paths[path] = paths.get(path, 0) + 1
            want = url_category(path, rules)
            if r.get("category") != want:
                bad.append(f"category {r.get('category')!r} of "
                           f"{r['path']!r}, want {want!r}")
        elif "category" in r:
            bad.append(f"a category on a {r.get('protocol')} "
                       f"{r.get('kind')}: {r}")
        if len(bad) >= limit:
            return bad
    if paths != expected["http_paths"]:
        bad.append(f"request paths {paths}, want {expected['http_paths']}")
    want_spans = sorted((n, lat) for n, _code, lat in expected["spans"])
    if sorted(spans) != want_spans:
        bad.append(f"{len(spans)} spans, want {len(want_spans)}, or their "
                   f"names and latencies differ")
    want_cells = {k: dict(v) for k, v in expected["cells"].items()}
    if cells != want_cells:
        diff = sorted(set(cells) ^ set(want_cells)) or [
            k for k in want_cells if cells[k] != want_cells[k]]
        bad.append(f"rollup cells differ at {diff[:3]}")
    return bad[:limit]


# -- flusher routing ----------------------------------------------------------

ROUTE_STORES = (("gets", "GET"), ("posts", "POST"))


def route_config(log_paths, outs):
    """Two pipelines, each over its own copy of an Apache log
    (``log_paths``: the JAX package's file checkpoints are keyed by
    (dev, inode) across pipelines, so two inputs of one file would read it
    once in all) — ``input_file``, the Apache parse,
    ``aggregator_logstore_router`` on ``method`` by ``ROUTE_STORES``),
    each with two ``flusher_file`` sinks that carry a ``Match``.  ``outs``
    maps ``a``, ``b``, ``c``, ``d`` to sink paths.  Pipeline ``only`` sends
    ``__logstore__: gets`` groups to ``a`` and metrics to ``b`` (so every
    other group matches no flusher and is dropped, tagged ``no_route``);
    pipeline ``fan`` sends every log group to ``c`` and the ``gets``
    groups also to ``d``.  The router's buckets close at 256 events or at
    the stop-time drain (no timeout inside a run), so the groups and their
    order do not depend on the run's pace.  Returns {file name: YAML}."""
    keys = ", ".join(APACHE_KEYS)
    regex = ", ".join(f"'{m}'" for _s, m in ROUTE_STORES)
    stores = ", ".join(s for s, _m in ROUTE_STORES)
    head = """inputs:
  - Type: input_file
    FilePaths: [{log}]
processors:
  - Type: processor_parse_regex_native
    SourceKey: content
    Regex: '{apache}'
    Keys: [{keys}]
aggregators:
  - Type: aggregator_logstore_router
    SourceKey: method
    RouterRegex: [{regex}]
    RouterLogstore: [{stores}]
    MaxLogCount: 256
    TimeoutSecs: 3600
flushers:
"""

    def sink(name, match):
        return (f"  - Type: flusher_file\n    FilePath: {outs[name]}\n"
                f"    Match: {match}\n")
    gets = "{Type: tag, Key: __logstore__, Value: gets}"
    def pipeline(log):
        return head.format(log=log, apache=APACHE, keys=keys, regex=regex,
                           stores=stores)
    return {
        "only.yaml": pipeline(log_paths[0]) + sink("a", gets)
        + sink("b", "{Type: event_type, Value: metric}"),
        "fan.yaml": pipeline(log_paths[1])
        + sink("c", "{Type: event_type, Value: log}") + sink("d", gets),
    }


# -- container stdout (kubelet pod-log layout, containerd text) --------------

CRI_NAMESPACE = "prod-web"
CRI_OTHER_NAMESPACE = "kube-system"


def cri_lines(records, seed=0, partial=0.02):
    """containerd text lines wrapping ``records`` (bytes): each record on
    ``stdout`` (70%) or ``stderr``, and a share ``partial`` of them cut
    into two or three pieces, written as ``P`` lines then an ``F`` line."""
    rng = np.random.default_rng(seed)
    out = []
    for i, rec in enumerate(records):
        stream = b"stdout" if rng.random() < 0.7 else b"stderr"
        ts = (f"2024-01-02T03:{(i // 60) % 60:02d}:{i % 60:02d}."
              f"{i % 1000000000:09d}Z").encode()
        if rng.random() < partial and len(rec) > 3:
            k = int(rng.integers(2, 4))
            cuts = sorted(rng.choice(np.arange(1, len(rec)), k - 1,
                                     replace=False).tolist())
            pieces = [rec[a:b] for a, b in zip([0] + cuts, cuts + [len(rec)])]
            for j, piece in enumerate(pieces):
                flag = b"F" if j == len(pieces) - 1 else b"P"
                out.append(b" ".join((ts, stream, flag, piece)))
        else:
            out.append(b" ".join((ts, stream, b"F", rec)))
    return out


def write_cri_tree(root, n_prod=8, n_other=2, lines_per_pod=25000, seed=0,
                   partial=0.02, records=None):
    """The kubelet pod-log tree under ``root``: ``n_prod`` pods in
    ``CRI_NAMESPACE`` and ``n_other`` in ``CRI_OTHER_NAMESPACE``, one
    container (``app``) each, whose ``0.log`` holds ``cri_lines`` of
    ``lines_per_pod`` Apache lines: ``gen_lines`` with the pod's own seed,
    or the pod's slice of ``records`` when given.  Returns
    {log path: (namespace, pod, cri lines, Apache lines)}."""
    import os
    out = {}
    pods = ([(CRI_NAMESPACE, f"web-{k}") for k in range(n_prod)]
            + [(CRI_OTHER_NAMESPACE, f"dns-{k}") for k in range(n_other)])
    for k, (ns, pod) in enumerate(pods):
        d = os.path.join(root, f"{ns}_{pod}_uid{k:04d}", "app")
        os.makedirs(d, exist_ok=True)
        if records is None:
            recs = gen_lines(lines_per_pod, seed=seed * 1000 + k)
        else:
            recs = records[k * lines_per_pod:(k + 1) * lines_per_pod]
        lines = cri_lines(recs, seed=seed * 1000 + k, partial=partial)
        path = os.path.join(d, "0.log")
        with open(path, "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
        out[path] = (ns, pod, lines, recs)
    return out


def cri_merged(lines, chunk_size=512 * 1024):
    """What the unwrap and the flag-mode merge make of one container log
    read in reader chunks (``reader_chunks``): [(stream, content, split)],
    in order.  A run of ``P`` lines merges with the line after it inside
    one chunk only (the JAX package's ``merge_multiline.py:58-64``): a run
    a chunk boundary cuts ships as two records, both marked ``split``."""
    out = []
    open_run = False
    for chunk in reader_chunks(lines, chunk_size):
        parsed = [ln.split(b" ", 3) for ln in chunk]
        n = len(parsed)
        i = 0
        while i < n:
            j = i
            while j < n and parsed[j][2] == b"P":
                j += 1
            last = min(j, n - 1)
            content = b"".join(p[3] for p in parsed[i:last + 1])
            split = (i == 0 and open_run) or j == n
            out.append((parsed[i][1], content, split))
            i = last + 1
        open_run = n > 0 and parsed[-1][2] == b"P"
    return out


def container_loki_config(url):
    """The container stdout path, as YAML: the shipped
    ``example_config/quick_start/k8s_stdio_to_loki.yaml`` with a
    ``processor_parse_regex_tpu`` of the Apache pattern and keys and the
    Loki ``URL`` pointed at ``url``.  The pod-log root comes from
    ``LOONG_CRI_POD_LOG_DIR``."""
    keys = ", ".join(APACHE_KEYS)
    return f"""inputs:
  - Type: input_container_stdio
    ContainerFilters:
      K8sNamespaceRegex: "prod.*"
processors:
  - Type: processor_parse_regex_tpu
    SourceKey: content
    Regex: '{APACHE}'
    Keys: [{keys}]
flushers:
  - Type: flusher_loki
    URL: "{url}"
    TenantID: team-a
    StaticLabels: {{job: loongcollector}}
    DynamicLabels: [_namespace_, _pod_name_]
"""


def loki_records(bodies):
    """[(labels, ts_ns, line)] of Loki push bodies (JSON), in order."""
    import json
    out = []
    for body in bodies:
        for stream in json.loads(body)["streams"]:
            labels = tuple(sorted(stream["stream"].items()))
            for ts, line in stream["values"]:
                out.append((labels, ts, line))
    return out


# -- SPL ------------------------------------------------------------------------

SPL_TEAMS = ("payments", "search", "growth", "infra")
SPL_REGIONS = ("us-west-2", "eu-central-1", "ap-south-1")


def gen_requests(n, seed=0, users=500):
    """``user_id status latency_ms`` lines (``spl_enrich_join.yaml``'s
    input)."""
    rng = np.random.default_rng(seed)
    uid = rng.integers(0, users, n)
    st = rng.choice(np.array([200, 201, 204, 301, 404, 429, 500, 502, 503]),
                    n)
    lat = rng.integers(0, 5000, n)
    return [f"u{u} {s} {t}".encode() for u, s, t in zip(uid, st, lat)]


def teams_csv(users=500, seed=0, share=0.8):
    """The join table ``user_id,team,region`` for a share of the users
    (the rest stay un-joined)."""
    rng = np.random.default_rng(seed)
    rows = ["user_id,team,region"]
    for u in range(users):
        if rng.random() < share:
            rows.append(f"u{u},{SPL_TEAMS[int(rng.integers(len(SPL_TEAMS)))]},"
                        f"{SPL_REGIONS[int(rng.integers(len(SPL_REGIONS)))]}")
    return ("\n".join(rows) + "\n").encode()


def spl_enrich_join_config(log_path, csv_path, out_path):
    """``example_config/quick_start/spl_enrich_join.yaml`` as shipped, with
    ``FilePaths`` and the join table pointed at ``log_path`` and
    ``csv_path``, and a ``flusher_file`` sink at ``out_path`` in place of
    ``flusher_stdout``."""
    return f"""inputs:
  - Type: input_file
    FilePaths:
      - {log_path}
processors:
  - Type: processor_parse_regex_tpu
    SourceKey: content
    Regex: '(\\S+) (\\d+) (\\d+)'
    Keys: [user_id, status, latency_ms]
  - Type: processor_spl
    Script: >
      * | extend sev = if(status >= 500, 'error', 'ok')
        | extend bucket = concat(sev, '-', round(div(latency_ms, 100)))
        | join type=left file('{csv_path}') on user_id
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


# the SPL Apache script's stages: a named parse (Tier 1), a Tier-1 and a
# DFA-tier ``where … matches``, and an ``extend`` with ``if``
SPL_APACHE_STATUS = r"[45]\d\d"
SPL_APACHE_URL = r".*\.(?:js|png|html)"
SPL_APACHE_NAMED = "".join(
    f"(?P<{k}>{g})" if g else lit for k, g, lit in (
        ("ip", r"\S+", None), (None, None, " "), ("ident", r"\S+", None),
        (None, None, " "), ("user", r"\S+", None), (None, None, r" \["),
        ("time", r"[^\]]+", None), (None, None, r'\] "'),
        ("method", r"\S+", None), (None, None, " "), ("url", r"\S+", None),
        (None, None, " "), ("protocol", r'[^"]*', None), (None, None, '" '),
        ("status", r"\d{3}", None), (None, None, " "),
        ("size", r"\d+", None)))


def spl_apache_script():
    return (f"* | parse content with regex '{SPL_APACHE_NAMED}'"
            f" | where status matches '{SPL_APACHE_STATUS}'"
            f" | where url matches '{SPL_APACHE_URL}'"
            f" | extend kind = if(status >= 500, 'server', 'client')")


def spl_apache_config(log_path, out_path):
    """An Apache log through ``processor_spl`` alone
    (``spl_apache_script``), ``flusher_file``."""
    script = spl_apache_script().replace("'", "''")
    return f"""inputs:
  - Type: input_file
    FilePaths: [{log_path}]
processors:
  - Type: processor_spl
    Script: '{script}'
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


# -- regroup by metadata (es_with_aggregation.yaml) ---------------------------

META_APPS = ("web", "api", "db", "cache", "auth")


def gen_app_lines(n, seed=0):
    """``app action latency_ms`` lines (``es_with_aggregation.yaml``'s
    grok)."""
    rng = np.random.default_rng(seed)
    apps = rng.integers(0, len(META_APPS), n)
    acts = rng.choice(np.array(["get", "put", "list", "delete"]), n)
    lat = rng.integers(0, 100000, n)
    return [f"{META_APPS[a]} {c} {t}".encode()
            for a, c, t in zip(apps, acts, lat)]


def metadata_group_config(log_path, out_path):
    """``example_config/quick_start/es_with_aggregation.yaml`` with
    ``FilePaths`` pointed at ``log_path`` and a ``flusher_file`` sink at
    ``out_path`` in place of ``flusher_elasticsearch``."""
    return f"""inputs:
  - Type: input_file
    FilePaths:
      - {log_path}
processors:
  - Type: processor_grok
    Match: "%{{DATA:app}} %{{DATA:action}} %{{INT:latency_ms}}"
aggregators:
  - Type: aggregator_metadata_group
    GroupMetadataKeys: [app]
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


def es_aggregation_config(log_path, url):
    """``example_config/quick_start/es_with_aggregation.yaml`` as shipped,
    with ``FilePaths`` pointed at ``log_path`` and ``Addresses`` at the
    ``_bulk`` receiver ``url`` in place of ``http://localhost:9200``."""
    return f"""inputs:
  - Type: input_file
    FilePaths:
      - {log_path}
processors:
  - Type: processor_grok
    Match: "%{{DATA:app}} %{{DATA:action}} %{{INT:latency_ms}}"
aggregators:
  - Type: aggregator_metadata_group
    GroupMetadataKeys: [app]
flushers:
  - Type: flusher_elasticsearch
    Addresses: ["{url}"]
    Index: "logs-%{{app}}"
    Authentication:
      PlainText: {{Username: elastic, Password: changeme}}
"""


def es_bulk_rows(bodies):
    """[(index, source dict)] of ``_bulk`` bodies (action / source line
    pairs); raises on a line that is not one of a pair."""
    import json
    out = []
    for body in bodies:
        lines = body.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        if len(lines) % 2:
            raise ValueError("a _bulk body of an odd number of lines")
        for a, s in zip(lines[0::2], lines[1::2]):
            out.append((json.loads(a)["index"]["_index"], json.loads(s)))
    return out


# -- HTTP ingest (http_ingest_spl.yaml, influx_ingest.yaml) ---------------------

INGEST_ROUTES = tuple(f"/api/v1/{r}" for r in (
    "users", "orders", "cart", "search", "login", "logout", "items",
    "prices", "stock", "reviews", "ship", "pay", "refund", "coupons",
    "profile", "health", "metrics", "feed", "notify", "upload"))
INGEST_LEVELS = ("INFO", "WARN", "ERROR")


def gen_ingest_records(n, seed=0):
    """NDJSON request records ``{"level", "route", "latency_ms"}``: 10%
    ``DEBUG``, the rest INFO / WARN / ERROR, over ``INGEST_ROUTES``."""
    import json
    rng = np.random.default_rng(seed)
    debug = rng.random(n) < 0.10
    lv = rng.integers(0, len(INGEST_LEVELS), n)
    rt = rng.integers(0, len(INGEST_ROUTES), n)
    lat = rng.integers(0, 3000, n)
    return [json.dumps({"level": "DEBUG" if d else INGEST_LEVELS[v],
                        "route": INGEST_ROUTES[r],
                        "latency_ms": int(t)}).encode()
            for d, v, r, t in zip(debug, lv, rt, lat)]


def ingest_spl_rows(posts):
    """``ingest_spl_runs`` of ``posts``, one list of rows."""
    return [row for run in ingest_spl_runs(posts) for row in run]


def ingest_spl_runs(posts):
    """What ``http_ingest_spl.yaml``'s SPL makes of each POST (one group),
    a tuple of rows a POST: its non-DEBUG records counted and their
    ``latency_ms`` averaged by ``route``, as rows ``(route, count,
    avg_latency_ms)`` with the SPL's number text (an integer without a
    point, else ``repr``), by descending count, routes of equal count in
    first-seen order."""
    import json
    out = []
    for post in posts:
        by = {}
        for line in post:
            rec = json.loads(line)
            if rec["level"] == "DEBUG":
                continue
            acc = by.setdefault(rec["route"], [0, 0])
            acc[0] += 1
            acc[1] += rec["latency_ms"]
        rows = []
        for route, (n, total) in sorted(by.items(), key=lambda kv: -kv[1][0]):
            avg = total / n
            text = str(int(avg)) if avg.is_integer() else repr(avg)
            rows.append((route, str(n), text))
        out.append(tuple(rows))
    return out


def http_ingest_spl_config(port, url):
    """``example_config/quick_start/http_ingest_spl.yaml`` as shipped, with
    the input on ``127.0.0.1:port`` and ``Addresses`` at the ClickHouse
    receiver ``url`` in place of ``http://clickhouse:8123``."""
    return f"""inputs:
  - Type: input_http_server
    Address: "127.0.0.1:{port}"
    Format: ndjson
processors:
  - Type: processor_spl
    Script: "* | where level != 'DEBUG' | stats count(), avg(latency_ms) by route | sort by -count"
flushers:
  - Type: flusher_clickhouse
    Addresses: ["{url}"]
    Database: logs
    Table: route_stats
"""


def gen_influx_lines(n, seed=0, t0_ns=1_700_000_000_000_000_000):
    """Influx line-protocol points ``cpu,host=…,region=… usage_user=…,
    usage_system=…,procs=…i <ns>``, one a second from ``t0_ns`` (a sink
    that writes whole seconds still shows each point's own time), each
    sample unique by (host, region, timestamp)."""
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, 64, n)
    regions = rng.integers(0, len(SPL_REGIONS), n)
    user = (rng.integers(0, 10000, n) / 100.0).tolist()
    system = (rng.integers(0, 10000, n) / 100.0).tolist()
    procs = rng.integers(1, 2000, n).tolist()
    return [(f"cpu,host=h{h},region={SPL_REGIONS[r]} usage_user={u!r},"
             f"usage_system={s!r},procs={p}i {t0_ns + i * 1_000_000_000}"
             ).encode()
            for i, (h, r, u, s, p) in enumerate(zip(hosts, regions, user,
                                                    system, procs))]


def influx_samples(lines):
    """{(host, region, ts_ns): {field: value}} of ``gen_influx_lines``."""
    out = {}
    for line in lines:
        head, fields, ts = line.decode().split(" ")
        tags = dict(kv.split("=") for kv in head.split(",")[1:])
        vals = {}
        for kv in fields.split(","):
            k, v = kv.split("=")
            vals[k] = float(v[:-1] if v.endswith("i") else v)
        out[(tags["host"], tags["region"], int(ts))] = vals
    return out


def influx_ingest_config(port, out_path):
    """``example_config/quick_start/influx_ingest.yaml`` with the input on
    ``127.0.0.1:port`` and a ``flusher_file`` sink at ``out_path`` in place
    of ``flusher_stdout``."""
    return f"""inputs:
  - Type: input_http_server
    Address: 127.0.0.1:{port}
    Format: influx
flushers:
  - Type: flusher_file
    FilePath: {out_path}
"""


# -- the extension plane (http_with_extensions.yaml) ---------------------------

EXT_ENVS = ("prod", "dev", "staging")
EXT_USER, EXT_PASSWORD = "agent", "s3cret"


def gen_extension_records(n, seed=0):
    """JSON records ``{"id", "env", "msg"}`` with unique ids, ``env`` over
    ``EXT_ENVS``."""
    import json
    rng = np.random.default_rng(seed)
    envs = rng.integers(0, len(EXT_ENVS), n)
    return [json.dumps({"id": str(i), "env": EXT_ENVS[e],
                        "msg": f"event {i}"}).encode()
            for i, e in enumerate(envs)]


def http_extensions_config(port, url, window_s=30):
    """``example_config/quick_start/http_with_extensions.yaml`` with the
    input on ``127.0.0.1:port``, ``RemoteURL`` at ``url``, the request
    breaker's ``WindowInSeconds`` at ``window_s`` (30 as shipped), and an
    ``aggregator_content_value_group`` by ``env``: it makes each record's
    ``env`` a group tag, which is what ``ext_groupinfo_filter`` reads (no
    plugin of the shipped config tags a group)."""
    return f"""extensions:
  - Type: ext_default_decoder
    Format: json
  - Type: ext_basicauth
    Username: {EXT_USER}
    Password: {EXT_PASSWORD}
  - Type: ext_request_breaker
    FailureRatio: 0.2
    WindowInSeconds: {window_s}
  - Type: ext_groupinfo_filter
    Tags: {{env: prod}}
inputs:
  - Type: input_http_server
    Address: 127.0.0.1:{port}
    Decoder: ext_default_decoder
aggregators:
  - Type: aggregator_content_value_group
    GroupKeys: [env]
flushers:
  - Type: flusher_http
    RemoteURL: {url}
    Authenticator: ext_basicauth
    RequestBreaker: ext_request_breaker
    FlushInterceptor: ext_groupinfo_filter
"""


# -- host metrics (metrics_remote_write.yaml, process_entities.yaml) ----------

def host_metrics_config(url, interval_s=15):
    """``example_config/quick_start/metrics_remote_write.yaml`` with the
    remote-write ``Endpoint`` at ``url``.  The shipped file sets
    ``IntervalSecs: 15``, a key neither package reads (both read
    ``IntervalSeconds``, default 60); this config sets ``IntervalSeconds:
    interval_s``."""
    return f"""inputs:
  - Type: input_host_monitor
    Collectors: [cpu, mem, disk, net, gpu]
    IntervalSeconds: {interval_s}
processors: []
flushers:
  - Type: flusher_prometheus
    Endpoint: "{url}"
"""


SLS_PROJECT = "127"
SLS_LOGSTORE = "host-entities"
SLS_AK_ID, SLS_AK_SECRET = "LTAI-test-key-id", "test-key-secret"


def process_entities_config(port, interval_s=60):
    """``example_config/quick_start/process_entities.yaml`` with
    ``IntervalSeconds: interval_s``, fake keys, and the SLS endpoints on
    the loopback: the flusher's host is ``<Project>.<Endpoint>``, so
    ``Project: "127"`` and ``Endpoint: "0.0.1:<port>"`` put it at
    ``127.0.0.1:<port>`` (a name lookup of the shipped host is never
    made); the second endpoint is ``127.0.0.2:<port>``."""
    return f"""inputs:
  - Type: input_process_entity
    IntervalSeconds: {interval_s}
    TopN: 50
flushers:
  - Type: flusher_sls
    Project: "{SLS_PROJECT}"
    Logstore: {SLS_LOGSTORE}
    Endpoint: "0.0.1:{port}"
    Endpoints: ["0.0.1:{port}", "0.0.2:{port}"]
    AccessKeyId: {SLS_AK_ID}
    AccessKeySecret: {SLS_AK_SECRET}
"""
