"""processor_spl — pipeline query language over event groups.

Reference: core/plugin/processor/ProcessorSPL.cpp bridges the (closed) SLS
SPL engine; this framework implements the practically-used core of the
language natively, columnar-first:

    * | where level = 'ERROR'
      | where msg matches 'timeout.*'        (device regex tier)
      | where latency > 100
      | parse content with regex '(?P<ip>\\S+) .*'
      | extend combo = concat(host, ':', level)
      | rename old as new
      | project a, b, c          /  project-away x, y
      | limit 100

Stages execute left to right on the whole group; `where matches` runs the
tiered device engine; `parse with regex` is the Tier-1 extraction kernel.
Unsupported constructs fail init (surfaced at config load), never silently.

The port's copy of the JAX package's ``processor/spl.py``.  The engines of
``where … matches`` and ``parse … with regex`` are built on the pipeline's
device (``compile_spl(script, device)``): a Tier-1 pattern runs K1, a
DFA-tier ``matches`` runs K2, each through the engine's synchronous
``match_batch`` / ``parse_batch``.  A DFA-tier ``parse`` with captures
runs on ``re``, as in the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models import ColumnarLogs, PipelineEventGroup
from ..ops.regex.engine import RegexEngine, get_engine
from ..pipeline.plugin.interface import PluginContext, Processor
from .common import extract_source
from .filter import compact_columns


class SPLError(Exception):
    pass


_WHERE_RE = re.compile(
    r"where\s+(\w+)\s*(>=|<=|!=|=|>|<|contains|matches)\s*(.+)", re.S)
_PARSE_RE = re.compile(r"parse\s+(\w+)\s+with\s+regex\s+(.+)", re.S)
_EXTEND_RE = re.compile(r"extend\s+(\w+)\s*=\s*(.+)", re.S)
_RENAME_RE = re.compile(r"rename\s+(\w+)\s+as\s+(\w+)")
_PROJECT_RE = re.compile(r"project(-away)?\s+(.+)")
_LIMIT_RE = re.compile(r"limit\s+(\d+)")
_STATS_RE = re.compile(r"stats\s+(.+?)(?:\s+by\s+([\w,\s]+))?\s*$", re.S)
_SORT_RE = re.compile(r"sort\s+by\s+(.+)", re.S)
_JOIN_RE = re.compile(
    r"join\s+(?:type\s*=\s*(inner|left)\s+)?"
    r"file\(\s*(['\"][^'\"]+['\"])\s*\)\s+on\s+(\w+)", re.S)


def _split_quote_aware(text: str, sep: str) -> List[str]:
    """Split on sep outside single/double-quoted spans (quotes may contain
    the separator — regex alternation pipes, literal commas)."""
    out: List[str] = []
    cur: List[str] = []
    quote = ""
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            cur.append(c)
            if c == quote:
                quote = ""
        elif c in "'\"":
            quote = c
            cur.append(c)
        elif c == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _unquote(v: str) -> str:
    v = v.strip()
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    return v


class _Stage:
    def apply(self, group: PipelineEventGroup) -> None:  # pragma: no cover
        raise NotImplementedError


class _Where(_Stage):
    def __init__(self, field: str, op: str, value: str, device=None):
        self.field = field.encode()
        self.op = op
        self.value = _unquote(value)
        self.engine: Optional[RegexEngine] = None
        if op == "matches":
            self.engine = get_engine(self.value, device)
        self.num: Optional[float] = None
        if op in (">", ">=", "<", "<="):
            try:
                self.num = float(self.value)
            except ValueError:
                raise SPLError(f"numeric comparison with non-number "
                               f"{self.value!r}")

    def apply(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.field)
        n = len(group)
        if src is None:
            keep = np.zeros(n, dtype=bool)
        elif self.op == "matches":
            keep = self.engine.match_batch(src.arena, src.offsets,
                                           src.lengths) & src.present
        else:
            keep = np.zeros(n, dtype=bool)
            want = self.value.encode()
            raw = src.arena
            for i in range(n):
                if not src.present[i]:
                    continue
                o, ln = int(src.offsets[i]), int(src.lengths[i])
                val = raw[o : o + ln].tobytes()
                if self.op == "=":
                    keep[i] = val == want
                elif self.op == "!=":
                    keep[i] = val != want
                elif self.op == "contains":
                    keep[i] = want in val
                else:
                    try:
                        x = float(val)
                    except ValueError:
                        continue
                    keep[i] = ((self.op == ">" and x > self.num)
                               or (self.op == ">=" and x >= self.num)
                               or (self.op == "<" and x < self.num)
                               or (self.op == "<=" and x <= self.num))
        _apply_keep(group, keep)


class _Parse(_Stage):
    def __init__(self, field: str, pattern: str, device=None):
        self.field = field
        self.engine = get_engine(_unquote(pattern), device)
        if not self.engine.group_names:
            raise SPLError("parse regex needs named groups (?P<name>...)")

    def apply(self, group: PipelineEventGroup) -> None:
        src = extract_source(group, self.field.encode())
        if src is None:
            return
        res = self.engine.parse_batch(src.arena, src.offsets, src.lengths)
        cols = group.columns
        ok = res.ok & src.present
        for g in range(self.engine.num_caps):
            name = self.engine.group_names.get(g)
            if not name:
                continue
            lens = np.where(ok, res.cap_len[:, g], -1).astype(np.int32)
            if cols is not None and not group._events:
                cols.set_field(name, res.cap_off[:, g], lens)
            else:
                sb = group.source_buffer
                for i, ev in enumerate(group.events):
                    if lens[i] >= 0 and hasattr(ev, "get_content"):
                        o = int(res.cap_off[i, g])
                        ev.set_content(name.encode(), sb.copy_string(
                            bytes(src.arena[o : o + lens[i]].tobytes())))


# ---------------------------------------------------------------------------
# extend expression language: nested function calls over row fields.
# Node = ('lit', bytes) | ('field', name) | ('call', fname, [args])
# ---------------------------------------------------------------------------

def _split_args(src: str) -> List[str]:
    """Split call arguments on top-level commas (quote- AND paren-aware —
    nested calls like round(div(a, b), 2) must not split inside div)."""
    out = []
    depth = 0
    quote = None
    start = 0
    for i, ch in enumerate(src):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(src[start:i])
            start = i + 1
    out.append(src[start:])
    return out


def _parse_expr(src: str):
    src = src.strip()
    if src and src[0] in "'\"":
        return ("lit", _unquote(src).encode())
    m = re.fullmatch(r"([A-Za-z_][\w]*)\((.*)\)", src, re.S)
    if m:
        fname = m.group(1).lower()
        inner = m.group(2).strip()
        if fname == "if":
            # first-class node so if() nests anywhere and validates at
            # compile time like every other function
            args = _split_args(inner)
            if len(args) != 3:
                raise SPLError("if() takes (cond, then, else)")
            cm = _CMP_RE.search(args[0])
            if not cm:
                raise SPLError(f"if() needs a comparison: {args[0]!r}")
            return ("if", _parse_expr(args[0][: cm.start()]), cm.group(1),
                    _parse_expr(args[0][cm.end():]), _parse_expr(args[1]),
                    _parse_expr(args[2]))
        args = ([_parse_expr(a) for a in _split_args(inner)]
                if inner else [])
        return ("call", fname, args)
    if re.fullmatch(r"-?\d+(\.\d+)?", src):
        return ("lit", src.encode())
    return ("field", src)


def _b2f(v: bytes) -> float:
    try:
        return float(v)
    except ValueError:
        return 0.0


_CMP_RE = re.compile(r"(==|!=|>=|<=|>|<)")


def _eval_expr(node, fields: Dict[str, bytes]) -> bytes:
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "field":
        return fields.get(node[1], b"")
    if kind == "if":
        _, lhs, op, rhs, then, other = node
        lv = _eval_expr(lhs, fields)
        rv = _eval_expr(rhs, fields)
        ln, rn = _num(lv), _num(rv)
        if ln is not None and rn is not None:
            lv, rv = ln, rn            # numeric compare when both parse
        ok = {"==": lv == rv, "!=": lv != rv, ">": lv > rv,
              "<": lv < rv, ">=": lv >= rv, "<=": lv <= rv}[op]
        return _eval_expr(then if ok else other, fields)
    fname, args = node[1], node[2]
    a = [_eval_expr(x, fields) for x in args]
    # string functions (SLS SPL vocabulary)
    if fname == "concat":
        return b"".join(a)
    if fname == "upper":
        return a[0].upper()
    if fname == "lower":
        return a[0].lower()
    if fname == "trim":
        return a[0].strip()
    if fname == "ltrim":
        return a[0].lstrip()
    if fname == "rtrim":
        return a[0].rstrip()
    if fname == "length":
        return str(len(a[0])).encode()
    if fname == "reverse":
        return a[0][::-1]
    if fname == "substring":
        start = int(_b2f(a[1]))
        n = int(_b2f(a[2])) if len(a) > 2 else len(a[0])
        return a[0][start:start + n]
    if fname == "replace":
        return a[0].replace(a[1], a[2])
    if fname == "split_part":
        parts = a[0].split(a[1])
        idx = int(_b2f(a[2])) - 1          # SPL split_part is 1-based
        return parts[idx] if 0 <= idx < len(parts) else b""
    if fname == "md5":
        import hashlib as _h
        return _h.md5(a[0]).hexdigest().encode()
    if fname == "url_encode":
        from urllib.parse import quote
        return quote(a[0].decode("utf-8", "replace")).encode()
    if fname == "url_decode":
        from urllib.parse import unquote
        return unquote(a[0].decode("utf-8", "replace")).encode()
    if fname == "json_extract":
        import json as _json
        try:
            doc = _json.loads(a[0])
            for part in a[1].decode().strip("$.").split("."):
                if part:
                    doc = doc[int(part)] if isinstance(doc, list) else \
                        doc[part]
            if isinstance(doc, (dict, list)):
                return _json.dumps(doc, separators=(",", ":")).encode()
            return str(doc).encode()
        except (ValueError, KeyError, IndexError, TypeError):
            return b""
    if fname == "coalesce":
        for v in a:
            if v:
                return v
        return b""
    # math
    if fname in ("add", "sub", "mul", "div", "mod", "pow"):
        x, y = _b2f(a[0]), _b2f(a[1])
        try:
            val = {"add": x + y, "sub": x - y, "mul": x * y,
                   "div": x / y if y else 0.0,
                   "mod": x % y if y else 0.0, "pow": x ** y}[fname]
        except (OverflowError, ValueError):
            val = 0.0
        return _fmt(val)
    if fname == "round":
        nd = int(_b2f(a[1])) if len(a) > 1 else 0
        return _fmt(round(_b2f(a[0]), nd))
    if fname == "abs":
        return _fmt(abs(_b2f(a[0])))
    if fname == "floor":
        import math as _m
        return _fmt(_m.floor(_b2f(a[0])))
    if fname == "ceil":
        import math as _m
        return _fmt(_m.ceil(_b2f(a[0])))
    # time
    if fname == "now":
        import time as _t
        return str(int(_t.time())).encode()
    if fname == "from_unixtime":
        import time as _t
        fmt = (a[1].decode("utf-8", "replace") if len(a) > 1
               else "%Y-%m-%d %H:%M:%S")
        try:
            return _t.strftime(fmt, _t.gmtime(_b2f(a[0]))).encode()
        except (ValueError, OverflowError):
            return b""
    raise SPLError(f"unknown SPL function {fname!r}")


class _Extend(_Stage):
    """extend dst = <expr> — nested function calls (concat/upper/substring/
    replace/split_part/md5/json_extract/add/round/if/from_unixtime/...),
    field refs and literals."""

    def __init__(self, dst: str, expr: str):
        self.dst = dst
        self.node = _parse_expr(expr.strip())
        # validate function names at compile time on an empty row;
        # data-dependent runtime errors (empty separators etc.) are
        # not compile errors
        try:
            _eval_expr(self.node, {})
        except SPLError:
            raise
        except Exception:  # noqa: BLE001
            pass

    def _value(self, fields: Dict[str, bytes]) -> bytes:
        return _eval_expr(self.node, fields)

    def apply(self, group: PipelineEventGroup) -> None:
        sb = group.source_buffer
        cols = group.columns
        if cols is not None and not group._events:
            rows = _row_fields(group)
            n = len(rows)
            offs = np.zeros(n, dtype=np.int32)
            lens = np.full(n, -1, dtype=np.int32)
            for i, fields in enumerate(rows):
                view = sb.copy_string(self._value(fields))
                offs[i] = view.offset
                lens[i] = view.length
            cols.set_field(self.dst, offs, lens)
            return
        for ev in group.events:
            if not hasattr(ev, "contents"):
                continue
            fields = {k.to_str(): v.to_bytes() for k, v in ev.contents}
            ev.set_content(self.dst.encode(),
                           sb.copy_string(self._value(fields)))


class _Rename(_Stage):
    def __init__(self, old: str, new: str):
        self.old, self.new = old, new

    def apply(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is not None and not group._events:
            if self.old in cols.fields:
                cols.fields[self.new] = cols.fields.pop(self.old)
            return
        for ev in group.events:
            if hasattr(ev, "get_content"):
                v = ev.get_content(self.old.encode())
                if v is not None:
                    ev.set_content(self.new.encode(), v)
                    ev.del_content(self.old.encode())


class _Project(_Stage):
    def __init__(self, fields: List[str], away: bool):
        self.fields = fields
        self.away = away

    def apply(self, group: PipelineEventGroup) -> None:
        cols = group.columns
        if cols is not None and not group._events:
            if self.away:
                for f in self.fields:
                    cols.fields.pop(f, None)
            else:
                cols.fields = {k: v for k, v in cols.fields.items()
                               if k in self.fields}
                if "content" not in self.fields:
                    cols.content_consumed = True
            return
        keep = set(self.fields)
        for ev in group.events:
            if not hasattr(ev, "contents"):
                continue
            names = [k.to_bytes() for k, _ in ev.contents]
            for name in names:
                present = name.decode("utf-8", "replace") in keep
                if self.away == present:
                    ev.del_content(name)


def _row_fields(group: PipelineEventGroup) -> List[Dict[str, bytes]]:
    """Per-event field dicts (shared by the aggregation verbs)."""
    cols = group.columns
    rows: List[Dict[str, bytes]] = []
    if cols is not None and not group._events:
        raw = group.source_buffer.as_array()
        n = len(cols)
        for i in range(n):
            fields: Dict[str, bytes] = {}
            for name, (fo, fl) in cols.fields.items():
                if fl[i] >= 0:
                    o = int(fo[i])
                    fields[name] = raw[o:o + int(fl[i])].tobytes()
            if not cols.content_consumed:
                o, ln = int(cols.offsets[i]), int(cols.lengths[i])
                fields.setdefault("content", raw[o:o + ln].tobytes())
            rows.append(fields)
        return rows
    for ev in group.events:
        if hasattr(ev, "contents"):
            rows.append({k.to_str(): v.to_bytes() for k, v in ev.contents})
        else:
            rows.append({})
    return rows


def _num(v: Optional[bytes]) -> Optional[float]:
    if v is None:
        return None
    try:
        x = float(v)
    except ValueError:
        return None
    # 'nan' poisons sorted() ordering and min/max; 'inf' breaks formatting
    return x if math.isfinite(x) else None


def _fmt(x: float) -> bytes:
    return (b"%d" % int(x)) if float(x).is_integer() else (
        repr(x).encode())


class _Stats(_Stage):
    """stats count(), sum(f), avg(f), min(f), max(f) [as alias], ...
    [by k1, k2] — the aggregation verbs the reference SPL engine exposes
    (ProcessorSPL.cpp:69-80); replaces the group's events with one event
    per key combination."""

    def __init__(self, aggs_src: str, by_src: Optional[str]):
        self.aggs: List[Tuple[str, Optional[str], str]] = []  # (fn, field, out)
        for part in _split_quote_aware(aggs_src, ","):
            part = part.strip()
            m = re.fullmatch(
                r"(count|sum|avg|min|max)\s*\(\s*(\w*)\s*\)"
                r"(?:\s+as\s+(\w+))?", part)
            if not m:
                raise SPLError(f"bad stats aggregate: {part!r}")
            fn, fieldname, alias = m.group(1), m.group(2) or None, m.group(3)
            if fn != "count" and not fieldname:
                raise SPLError(f"{fn}() needs a field")
            out = alias or (fn if fn == "count" and not fieldname
                            else f"{fn}_{fieldname}" if fieldname else fn)
            self.aggs.append((fn, fieldname, out))
        self.by = [k.strip() for k in (by_src or "").split(",") if k.strip()]

    def apply(self, group: PipelineEventGroup) -> None:
        rows = _row_fields(group)
        cols = group.columns
        tss = (cols.timestamps if cols is not None and not group._events
               else np.array([getattr(ev, "timestamp", 0)
                              for ev in group.events], dtype=np.int64))
        buckets: Dict[Tuple, Dict] = {}
        for i, fields in enumerate(rows):
            key = tuple(fields.get(k, b"") for k in self.by)
            b = buckets.get(key)
            if b is None:
                b = buckets[key] = {"n": 0, "vals": {}, "ts": 0}
            b["n"] += 1
            b["ts"] = max(b["ts"], int(tss[i]) if i < len(tss) else 0)
            for fn, fieldname, out in self.aggs:
                if fn == "count":
                    # count(field) counts rows where the field is present
                    # (SQL semantics); bare count() counts all rows
                    if fieldname:
                        b["vals"].setdefault(out, []).append(
                            1.0 if fieldname in fields else 0.0)
                    continue
                v = _num(fields.get(fieldname))
                if v is None:
                    continue
                acc = b["vals"].setdefault(out, [])
                acc.append(v)
        out_rows: List[Tuple[int, Dict[str, bytes]]] = []
        for key, b in buckets.items():
            fields: Dict[str, bytes] = {}
            for k, v in zip(self.by, key):
                fields[k] = v
            for fn, fieldname, out in self.aggs:
                if fn == "count":
                    if fieldname:
                        fields[out] = b"%d" % int(sum(b["vals"].get(out, [])))
                    else:
                        fields[out] = b"%d" % b["n"]
                    continue
                acc = b["vals"].get(out, [])
                if not acc:
                    fields[out] = b""
                elif fn == "sum":
                    fields[out] = _fmt(sum(acc))
                elif fn == "avg":
                    fields[out] = _fmt(sum(acc) / len(acc))
                elif fn == "min":
                    fields[out] = _fmt(min(acc))
                elif fn == "max":
                    fields[out] = _fmt(max(acc))
            out_rows.append((b["ts"], fields))
        self._rebuild(group, out_rows)

    @staticmethod
    def _rebuild(group: PipelineEventGroup,
                 out_rows: List[Tuple[int, Dict[str, bytes]]]) -> None:
        sb = group.source_buffer
        if group.columns is not None and not group._events:
            n = len(out_rows)
            new = ColumnarLogs(np.zeros(n, np.int32), np.zeros(n, np.int32),
                               np.array([r[0] for r in out_rows], np.int64))
            new.content_consumed = True
            names: List[str] = []
            for _, fields in out_rows:
                for name in fields:
                    if name not in names:
                        names.append(name)
            for name in names:
                offs = np.zeros(n, np.int32)
                lens = np.full(n, -1, np.int32)
                for i, (_, fields) in enumerate(out_rows):
                    v = fields.get(name)
                    if v is not None:
                        view = sb.copy_string(v)
                        offs[i], lens[i] = view.offset, view.length
                new.set_field(name, offs, lens)
            group.set_columns(new)
            return
        group._events = []
        group._columns = None   # stale pre-stats columns must not survive
        for ts, fields in out_rows:
            ev = group.add_log_event(ts)
            for k, v in fields.items():
                ev.set_content(sb.copy_string(k.encode()), sb.copy_string(v))


class _Sort(_Stage):
    """sort by f1 [desc], f2, ... — numeric when every value parses as a
    number, else bytewise; stable across keys (right-to-left passes)."""

    def __init__(self, keys_src: str):
        self.keys: List[Tuple[str, bool]] = []
        for part in keys_src.split(","):
            part = part.strip()
            desc = False
            if part.startswith("-"):
                desc, part = True, part[1:].strip()
            m = re.fullmatch(r"(\w+)(?:\s+(asc|desc))?", part)
            if not m:
                raise SPLError(f"bad sort key: {part!r}")
            self.keys.append((m.group(1), desc or m.group(2) == "desc"))

    def apply(self, group: PipelineEventGroup) -> None:
        n = len(group)
        if n <= 1:
            return
        cols = group.columns
        columnar = cols is not None and not group._events
        if columnar:
            # extract ONLY the key columns — materialising every field of
            # every row just to sort defeats the columnar layout
            raw = group.source_buffer.as_array()

            def get_col(name):
                spans = cols.fields.get(name)
                if spans is None and name == "content" \
                        and not cols.content_consumed:
                    spans = (cols.offsets, cols.lengths)
                if spans is None:
                    return [None] * n
                fo, fl = spans
                return [bytes(raw[int(fo[i]):int(fo[i]) + int(fl[i])]
                              .tobytes()) if fl[i] >= 0 else None
                        for i in range(n)]
        else:
            rows = _row_fields(group)

            def get_col(name):
                return [r.get(name) for r in rows]
        order = list(range(n))
        for name, desc in reversed(self.keys):
            col = get_col(name)
            vals = [col[i] for i in order]
            nums = [_num(v) for v in vals]
            if all(x is not None for x in nums):
                keyed = nums
            else:
                keyed = [v if v is not None else b"" for v in vals]
            idx = sorted(range(len(order)), key=lambda k: keyed[k],
                         reverse=desc)
            order = [order[k] for k in idx]
        perm = np.array(order, dtype=np.int64)
        if columnar:
            group.set_columns(compact_columns(cols, perm))
        else:
            group._events = [group.events[i] for i in order]
            group._columns = None   # any materialized columns are stale


class _Join(_Stage):
    """join [type=inner|left] file('<csv>') on <key> — hash join the event
    stream against a CSV lookup table (header row names the columns; the
    ON key must be one of them).  inner drops non-matching events; left
    keeps them without the lookup columns.  The SLS SPL engine joins
    datasets; an agent-side processor's second dataset is a local table."""

    def __init__(self, join_type: Optional[str], path_src: str, key: str):
        self.join_type = join_type or "inner"
        self.key = key
        self.path = _unquote(path_src)
        self.table: Optional[Dict[bytes, Dict[str, bytes]]] = None
        import os
        if os.path.exists(self.path):
            self._load()        # present at config time: fail fast on a
            # malformed table; an ABSENT table defers to runtime (lookup
            # files often ship separately from pipeline configs)

    def _load(self) -> None:
        import csv
        table: Dict[bytes, Dict[str, bytes]] = {}
        try:
            with open(self.path, newline="") as f:
                reader = csv.reader(f)
                header = next(reader, None)
                if not header or self.key not in header:
                    raise SPLError(f"join table {self.path!r} lacks key "
                                   f"column {self.key!r}")
                key_idx = header.index(self.key)
                for row in reader:
                    if len(row) != len(header):
                        continue
                    table[row[key_idx].encode()] = {
                        h: row[i].encode() for i, h in enumerate(header)
                        if i != key_idx}
        except OSError as e:
            raise SPLError(f"join table {self.path!r} unreadable: {e}")
        self.table = table

    def apply(self, group: PipelineEventGroup) -> None:
        if self.table is None:
            try:
                self._load()        # late-shipped table: retry per batch
            except SPLError:
                self.table = None
            if self.table is None:
                from ..utils.logger import get_logger
                get_logger("spl").warning(
                    "join table %s not loadable yet; passing events "
                    "through un-joined", self.path)
                return              # left-join-like passthrough until ready
        sb = group.source_buffer
        cols = group.columns
        if cols is not None and not group._events:
            group.materialize()     # join needs per-event mutation
            group._columns = None   # else dropped rows resurrect from cols
        keep = []
        for ev in group.events:
            fields = ({k.to_str(): v.to_bytes() for k, v in ev.contents}
                      if hasattr(ev, "contents") else {})
            row = self.table.get(fields.get(self.key, b""))
            if row is not None:
                for k, v in row.items():
                    ev.set_content(sb.copy_string(k.encode()),
                                   sb.copy_string(v))
                keep.append(ev)
            elif self.join_type == "left":
                keep.append(ev)
        group.events[:] = keep


class _Limit(_Stage):
    def __init__(self, n: int):
        self.n = n

    def apply(self, group: PipelineEventGroup) -> None:
        n = len(group)
        if n <= self.n:
            return
        keep = np.zeros(n, dtype=bool)
        keep[: self.n] = True
        _apply_keep(group, keep)


def _apply_keep(group: PipelineEventGroup, keep: np.ndarray) -> None:
    if keep.all():
        return
    cols = group.columns
    if cols is not None and not group._events:
        group.set_columns(compact_columns(cols, keep))
    else:
        group._events = [ev for i, ev in enumerate(group.events) if keep[i]]


def compile_spl(script: str, device=None) -> List[_Stage]:
    """The stages of ``script``; regex stages build their engines on
    ``device`` (CUDA when None)."""
    stages: List[_Stage] = []
    parts = [p.strip() for p in _split_quote_aware(script.strip(), "|")]
    if parts and parts[0].strip() in ("*", ""):
        parts = parts[1:]
    for part in parts:
        part = part.strip()
        if not part:
            continue
        if m := _WHERE_RE.fullmatch(part):
            stages.append(_Where(m.group(1), m.group(2), m.group(3),
                                 device))
        elif m := _PARSE_RE.fullmatch(part):
            stages.append(_Parse(m.group(1), m.group(2), device))
        elif m := _EXTEND_RE.fullmatch(part):
            stages.append(_Extend(m.group(1), m.group(2)))
        elif m := _RENAME_RE.fullmatch(part):
            stages.append(_Rename(m.group(1), m.group(2)))
        elif m := _PROJECT_RE.fullmatch(part):
            fields = [f.strip() for f in m.group(2).split(",")]
            stages.append(_Project(fields, away=bool(m.group(1))))
        elif m := _LIMIT_RE.fullmatch(part):
            stages.append(_Limit(int(m.group(1))))
        elif m := _STATS_RE.fullmatch(part):
            stages.append(_Stats(m.group(1), m.group(2)))
        elif m := _SORT_RE.fullmatch(part):
            stages.append(_Sort(m.group(1)))
        elif m := _JOIN_RE.fullmatch(part):
            stages.append(_Join(m.group(1), m.group(2), m.group(3)))
        else:
            raise SPLError(f"unsupported SPL stage: {part!r}")
    return stages


class ProcessorSPL(Processor):
    name = "processor_spl"
    supports_columnar = True

    def __init__(self) -> None:
        super().__init__()
        self.stages: List[_Stage] = []

    def init(self, config: Dict[str, Any], context: PluginContext) -> bool:
        super().init(config, context)
        script = config.get("Script", "")
        if not script:
            return False
        try:
            self.stages = compile_spl(script, context.device)
        except (SPLError, re.error) as e:
            from ..utils.logger import get_logger
            get_logger("spl").error("SPL compile failed: %s", e)
            return False
        return True

    def process(self, group: PipelineEventGroup) -> None:
        for stage in self.stages:
            stage.apply(group)
