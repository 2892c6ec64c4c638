"""Grok pattern expansion.

The port's copy of the JAX package's ``ops/regex/grok.py``: the same
default library and the same ``%{NAME:field}`` expansion, so every pattern
expands to the reference's string (``tests/test_torch_filter_grok.py``).
Expansion output feeds the tiered ``RegexEngine``; the library is written
kernel-friendly (negated-class forms rather than lazy dots wherever the
standard semantics allow), so common grok expressions compile to Tier-1
segment programs and run on K1.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

def _variants(*parts) -> list:
    """Cartesian concatenation of alternative lists — enumerates the exact
    language of a case-class/optional-suffix pattern as plain literals."""
    out = [""]
    for alts in parts:
        out = [a + b for a in out for b in alts]
    return out


def _loglevel_literals() -> str:
    """LOGLEVEL as an all-literal longest-first alternation.

    Same language as the classic `[Ww]arn?(?:ing)?`-style pattern (quirky
    forms like 'waring' included), but literal branches compile to the
    Tier-1 kernel: prefix pairs (WARN/WARNING) are sound under commit when
    ordered longest-first with a follow-set guard (program.py), which the
    class/optional formulation can never prove.
    """
    words = (
        _variants(["A", "a"], ["lert"]) + ["ALERT"]
        + _variants(["T", "t"], ["race"]) + ["TRACE"]
        + _variants(["D", "d"], ["ebug"]) + ["DEBUG"]
        + _variants(["N", "n"], ["otice"]) + ["NOTICE"]
        + _variants(["I", "i"], ["nf"], ["", "o"], ["", "rmation"])
        + _variants(["INF"], ["", "O"], ["", "RMATION"])
        + _variants(["W", "w"], ["ar"], ["", "n"], ["", "ing"])
        + _variants(["WAR"], ["", "N"], ["", "ING"])
        + _variants(["E", "e"], ["r"], ["", "r"], ["", "or"])
        + _variants(["ER"], ["", "R"], ["", "OR"])
        + _variants(["C", "c"], ["ri"], ["", "t"], ["", "ical"])
        + _variants(["CRI"], ["", "T"], ["", "ICAL"])
        + _variants(["F", "f"], ["atal"]) + ["FATAL"]
        + _variants(["S", "s"], ["evere"]) + ["SEVERE"]
        + _variants(["EMERG"], ["", "ENCY"])
        + _variants(["E", "e"], ["merg"], ["", "ency"])
    )
    uniq = sorted(set(words), key=lambda w: (-len(w), w))
    return "(?:" + "|".join(uniq) + ")"


# Standard grok vocabulary (public, logstash-compatible names).
DEFAULT_PATTERNS: Dict[str, str] = {
    "USERNAME": r"[a-zA-Z0-9._-]+",
    "USER": r"%{USERNAME}",
    "INT": r"[+-]?\d+",
    "BASE10NUM": r"[+-]?(?:\d+(?:\.\d+)?|\.\d+)",
    "NUMBER": r"%{BASE10NUM}",
    "BASE16NUM": r"(?:0[xX])?[0-9a-fA-F]+",
    "POSINT": r"\d+",
    "NONNEGINT": r"\d+",
    "WORD": r"\w+",
    "NOTSPACE": r"\S+",
    "SPACE": r"\s*",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "QUOTEDSTRING": r"\"[^\"]*\"",
    "UUID": r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}",
    "IPV4": r"(?:\d{1,3}\.){3}\d{1,3}",
    "IPV6": r"[0-9a-fA-F:.]+",
    "IP": r"%{IPV4}",
    "HOSTNAME": r"[a-zA-Z0-9._-]+",
    "IPORHOST": r"%{HOSTNAME}",
    "HOSTPORT": r"%{IPORHOST}:%{POSINT}",
    "PATH": r"(?:/[^ ]*)+",
    "UNIXPATH": r"(?:/[^ ]*)+",
    "URIPROTO": r"[A-Za-z]+(?:\+[A-Za-z+]+)?",
    "URIHOST": r"%{IPORHOST}(?::%{POSINT})?",
    "URIPATH": r"(?:/[^? ]*)+",
    "URIPARAM": r"\?[^ ]*",
    "URIPATHPARAM": r"%{URIPATH}(?:%{URIPARAM})?",
    "URI": r"%{URIPROTO}://(?:%{USER}(?::[^@]*)?@)?(?:%{URIHOST})?(?:%{URIPATHPARAM})?",
    "MONTH3": r"(?:Jan|Feb|Mar|Apr|May|Jun|Jul|Aug|Sep|Oct|Nov|Dec)",
    "MONTH": r"(?:Jan(?:uary)?|Feb(?:ruary)?|Mar(?:ch)?|Apr(?:il)?|May|Jun(?:e)?|Jul(?:y)?|Aug(?:ust)?|Sep(?:tember)?|Oct(?:ober)?|Nov(?:ember)?|Dec(?:ember)?)",
    "MONTHNUM": r"(?:1[0-2]|0[1-9]|[1-9])",
    "MONTHNUM2": r"(?:1[0-2]|0[1-9])",
    "MONTHDAY": r"(?:(?:0[1-9])|(?:[12][0-9])|(?:3[01])|[1-9])",
    "MONTHDAY2": r"(?:3[01]|[12][0-9]|0[1-9])",
    "DAY": r"(?:Mon(?:day)?|Tue(?:sday)?|Wed(?:nesday)?|Thu(?:rsday)?|Fri(?:day)?|Sat(?:urday)?|Sun(?:day)?)",
    "YEAR": r"(?:\d\d){1,2}",
    "HOUR": r"(?:2[0-3]|[01][0-9]|[0-9])",
    "HOUR2": r"(?:2[0-3]|[01][0-9])",
    "MINUTE": r"(?:[0-5][0-9])",
    "SECOND": r"(?:[0-5][0-9]|60)(?:[:.,][0-9]+)?",
    "TIME": r"%{HOUR2}:%{MINUTE}(?::%{SECOND})?",
    "DATE_US": r"%{MONTHNUM}[/-]%{MONTHDAY}[/-]%{YEAR}",
    "DATE_EU": r"%{MONTHDAY}[./-]%{MONTHNUM}[./-]%{YEAR}",
    "ISO8601_TIMEZONE": r"(?:Z|[+-]%{HOUR2}(?::?%{MINUTE}))",
    "ISO8601_SECOND": r"%{SECOND}",
    "TIMESTAMP_ISO8601": r"%{YEAR}-%{MONTHNUM2}-%{MONTHDAY2}[T ]%{HOUR2}:?%{MINUTE}(?::?%{SECOND})?%{ISO8601_TIMEZONE}?",
    "DATE": r"%{DATE_US}|%{DATE_EU}",
    "DATESTAMP": r"%{DATE}[- ]%{TIME}",
    "TZ": r"[A-Z]{3,4}",
    "HTTPDATE": r"%{MONTHDAY2}/%{MONTH3}/%{YEAR}:%{TIME} %{INT}",
    "SYSLOGTIMESTAMP": r"%{MONTH} +%{MONTHDAY} %{TIME}",
    "LOGLEVEL": _loglevel_literals(),
    # composite access-log patterns, kernel-friendly field classes: the
    # request field uses [^ "] (not \S) so the optional HTTP-version group
    # and closing quote never need backtracking — same semantics for
    # well-formed access logs, Tier-1 on device
    "NOTSPACEQ": r'[^ "]+',
    "COMMONAPACHELOG": (
        r'%{NOTSPACE:clientip} %{NOTSPACE:ident} %{NOTSPACE:auth} '
        r'\[%{HTTPDATE:timestamp}\] "%{WORD:verb} %{NOTSPACEQ:request}'
        r'(?: HTTP/%{NUMBER:httpversion})?" %{INT:response} '
        r'(?:%{POSINT:bytes}|-)'),
    # referrer/agent as [^"]* (not DATA=.*?): identical for well-formed
    # logs, backtracking-free on device
    "COMBINEDAPACHELOG": (
        r'%{COMMONAPACHELOG} "(?P<referrer>[^"]*)" "(?P<agent>[^"]*)"'),
    "NGINXACCESS": (
        r'%{NOTSPACE:remote_addr} - %{NOTSPACE:remote_user} '
        r'\[%{HTTPDATE:time_local}\] "%{WORD:method} %{NOTSPACE:request} '
        r'HTTP/%{NUMBER:http_version}" %{INT:status} %{INT:body_bytes_sent} '
        r'"([^"]*)" "([^"]*)"'),
}

_REF = re.compile(r"%\{(\w+)(?::([\w.\[\]@-]+))?\}")
MAX_DEPTH = 16


class GrokError(Exception):
    pass


def expand(pattern: str,
           custom: Optional[Dict[str, str]] = None,
           _depth: int = 0) -> str:
    """Expand %{NAME} / %{NAME:field} references into a plain regex with
    named capture groups."""
    if _depth > MAX_DEPTH:
        raise GrokError("grok expansion too deep (recursive pattern?)")
    library = DEFAULT_PATTERNS if not custom else {**DEFAULT_PATTERNS, **custom}
    out = []
    pos = 0
    for m in _REF.finditer(pattern):
        out.append(pattern[pos : m.start()])
        name, field = m.group(1), m.group(2)
        body = library.get(name)
        if body is None:
            raise GrokError(f"unknown grok pattern %{{{name}}}")
        body = expand(body, custom, _depth + 1)
        if field:
            safe = re.sub(r"\W", "_", field)
            out.append(f"(?P<{safe}>{body})")
        else:
            out.append(f"(?:{body})")
        pos = m.end()
    out.append(pattern[pos:])
    return "".join(out)
