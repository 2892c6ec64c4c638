"""The regrouping aggregators: the port's ``aggregator/base.py`` against the
JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_aggregators.py`` is a case of
one parametrised test (``CASES``): the same calls on the same groups
through both packages' aggregators give the same outputs — group sizes,
tags, metadata, the events of each output group (as bytes), which arena
each output group shares, and whether it re-references the input's event
objects.  Beside them: ``aggregator_logstore_router``,
``aggregator_opentelemetry`` and ``aggregator_skywalking`` on mixed
groups, each name's registration, and ``es_with_aggregation.yaml``'s grok
and ``aggregator_metadata_group`` through both ``--once`` agents.
"""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.aggregator import base as ref_base
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.pipeline.plugin.registry import \
    PluginRegistry as RefRegistry
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.aggregator import base as port_base
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.pipeline.plugin.registry import PluginRegistry
from test_torch_alarms import alarms_left_empty  # noqa: F401
from test_torch_container import containers_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIME = re.compile(rb'"__time__": \d+')

PKGS = {"ref": (ref_models, ref_base, RefContext),
        "port": (port_models, port_base, PluginContext)}


class Pkg:
    """One package's models, aggregators and context for a case."""

    def __init__(self, name):
        self.models, self.base, self._ctx = PKGS[name]
        self.Group = self.models.PipelineEventGroup
        self.Buf = self.models.SourceBuffer
        self.Meta = self.models.EventGroupMetaKey

    def ctx(self):
        return self._ctx("t")

    def agg(self, cls, cfg):
        a = getattr(self.base, cls)()
        assert a.init(cfg, self.ctx())
        return a

    def group(self, n_events, tags=(), meta=(), sb=None, field=None):
        g = self.Group(sb if sb is not None else self.Buf(1024))
        for k, v in tags:
            g.set_tag(k, v)
        for k, v in meta:
            g.set_metadata(getattr(self.Meta, k), v)
        for i in range(n_events):
            ev = g.add_log_event(i)
            ev.set_content(b"content", b"line %d" % i)
            if field:
                ev.set_content(field[0], field[1])
        return g


def describe(groups, inputs=()):
    """Each output group: size, tags, metadata, events (bytes), the input
    whose arena it shares and whether its events are the input's
    objects."""
    ins = list(inputs)
    out = []
    for g in groups:
        arena = next((i for i, src in enumerate(ins)
                      if src.source_buffer is g.source_buffer), None)
        objs = {id(e) for src in ins for e in src._events}
        events = [(type(ev).__name__, getattr(ev, "timestamp", None),
                   [(k.to_bytes(), v.to_bytes()) for k, v in ev.contents]
                   if hasattr(ev, "contents") else None)
                  for ev in g.events]
        out.append({
            "n": len(g),
            "tags": sorted((bytes(k), bytes(v)) for k, v in g.tags.items()),
            "meta": sorted((k.name, bytes(v))
                           for k, v in g.metadata.items()),
            "events": events, "arena": arena,
            "same_objects": all(id(e) in objs for e in g.events),
        })
    return out


def case_max_log_count_packs(p):
    agg = p.agg("AggregatorBase", {"MaxLogCount": 3})
    g = p.group(7)
    done = agg.add(g)
    rest = agg.flush()
    return describe(done, [g]), describe(rest, [g])


def case_arena_shared_no_byte_copy(p):
    agg = p.agg("AggregatorBase", {"MaxLogCount": 2})
    g = p.group(2, tags=((b"k", b"v"),))
    return describe(agg.add(g), [g])


def case_tag_fingerprint_separates_groups(p):
    agg = p.agg("AggregatorBase", {})
    sb = p.Buf(1024)
    g1 = p.group(1, tags=((b"a", b"1"),), sb=sb)
    g2 = p.group(1, tags=((b"a", b"2"),), sb=sb)
    agg.add(g1)
    agg.add(g2)
    return describe(agg.flush(), [g1, g2])


def case_arena_rotation_on_new_buffer(p):
    agg = p.agg("AggregatorBase", {"MaxLogCount": 100})
    g1, g2 = p.group(2), p.group(2)
    return (describe(agg.add(g1), [g1, g2]), describe(agg.add(g2), [g1, g2]),
            describe(agg.flush(), [g1, g2]))


def case_timeout_flush(p):
    agg = p.agg("AggregatorBase", {"TimeoutSecs": 0.0})
    g = p.group(2)
    agg.add(g)
    return describe(agg.flush_timeout(), [g]), describe(agg.flush(), [g])


def case_context_groups_by_source(p):
    agg = p.agg("AggregatorContext", {})
    sb = p.Buf(1024)
    meta_a = (("LOG_FILE_PATH", "/var/a.log"), ("LOG_FILE_INODE", "11"))
    meta_b = (("LOG_FILE_PATH", "/var/b.log"), ("LOG_FILE_INODE", "22"))
    gs = [p.group(2, meta=meta_a, sb=sb), p.group(1, meta=meta_b, sb=sb),
          p.group(1, meta=meta_a, sb=sb)]
    adds = [describe(agg.add(g), gs) for g in gs]
    return adds, describe(agg.flush(), gs)


def case_metadata_group_field_values(p):
    agg = p.agg("AggregatorMetadataGroup", {"GroupMetadataKeys": ["svc"]})
    sb = p.Buf(1024)
    g = p.Group(sb)
    for i, svc in enumerate((b"api", b"web", b"api")):
        ev = g.add_log_event(i)
        ev.set_content(b"svc", svc)
        ev.set_content(b"content", b"l%d" % i)
    return describe(agg.add(g), [g]), describe(agg.flush(), [g])


def case_metadata_group_missing_key(p):
    agg = p.agg("AggregatorMetadataGroup", {"GroupMetadataKeys": ["svc"]})
    g = p.group(2)
    agg.add(g)
    return describe(agg.flush(), [g])


def case_metadata_group_requires_keys(p):
    return p.base.AggregatorMetadataGroup().init({}, p.ctx())


def case_content_value_group_keys_and_topic(p):
    agg = p.agg("AggregatorContentValueGroup",
                {"GroupKeys": ["region"], "Topic": "metrics"})
    g = p.group(2, field=(b"region", b"eu"))
    agg.add(g)
    return describe(agg.flush(), [g])


def case_shardhash_md5_of_tag_values(p):
    agg = p.agg("AggregatorShardHash", {"ShardHashKeys": ["host", "src"]})
    g = p.group(1, tags=((b"host", b"h1"), (b"src", b"s9")))
    out = agg.add(g)
    assert out == [g]
    assert str(g.get_metadata(p.Meta.SOURCE_ID)) == \
        hashlib.md5(b"h1_s9").hexdigest()
    return describe(out, [g]), agg.flush()


def case_shardhash_missing_tags(p):
    agg = p.agg("AggregatorShardHash", {"ShardHashKeys": ["host"]})
    g = p.group(1)
    return describe(agg.add(g), [g])


def case_columnar_groups_pass_intact(p):
    out = []
    for cls, cfg in (("AggregatorBase", {}), ("AggregatorContext", {}),
                     ("AggregatorMetadataGroup", {"GroupMetadataKeys": ["k"]}),
                     ("AggregatorContentValueGroup", {"GroupKeys": ["k"]})):
        agg = p.agg(cls, cfg)
        g = p.Group(p.Buf(64))
        g.set_columns(p.models.ColumnarLogs(np.zeros(3, np.int32),
                                            np.zeros(3, np.int32)))
        got = agg.add(g)
        assert got == [g] and g._events == []
        out.append(len(got))
    return out


def _mixed(p, sb=None):
    """Log events with a ``method`` field, a metric, a span and a raw
    event, in one group."""
    g = p.Group(sb if sb is not None else p.Buf(4096))
    s = g.source_buffer
    g.set_tag(b"host", b"h1")
    for i, line in enumerate(td.gen_lines(40, seed=14)):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(b"content", s.copy_string(line))
        ev.set_content(b"method", s.copy_string(line.split(b'"')[1]
                                                .split()[0]))
        if i % 9 == 0:
            m = g.add_metric_event(1700000000 + i)
            m.name = b"cpu"
        if i % 13 == 0:
            sp = g.add_span_event(1700000000 + i)
            sp.name = b"op%d" % i
    return g


def case_logstore_router(p):
    out = []
    for cfg in ({"SourceKey": "method", "RouterRegex": ["GET", "P.*T"],
                 "RouterLogstore": ["gets", "puts_posts"],
                 "MaxLogCount": 7},
                {"SourceKey": "method", "RouterRegex": ["HEAD"],
                 "RouterLogstore": ["heads"], "DropDisMatch": True}):
        agg = p.agg("AggregatorLogstoreRouter", cfg)
        g = _mixed(p)
        out.append((describe(agg.add(g), [g]), describe(agg.flush(), [g])))
    bad = p.base.AggregatorLogstoreRouter()
    out.append(bad.init({"RouterRegex": ["a"], "RouterLogstore": []},
                        p.ctx()))
    return out


@pytest.mark.parametrize("cls", ["AggregatorTelemetryRouter",
                                 "AggregatorSkywalking"])
def test_telemetry_routers_match_reference(cls):
    got = {}
    for name in ("ref", "port"):
        p = Pkg(name)
        out = []
        for cfg in ({}, {"MetricsLogstore": "m", "TraceLogstore": "t",
                         "LogLogstore": "l", "Topic": "otel",
                         "MaxLogCount": 5}):
            agg = p.agg(cls, cfg)
            g = _mixed(p)
            out.append((describe(agg.add(g), [g]),
                        describe(agg.flush(), [g])))
        # a columnar group is materialized before it is routed
        lines = td.gen_lines(10, seed=3)
        data = b"\n".join(lines) + b"\n"
        sb = p.Buf(len(data) + 64)
        view = sb.copy_string(data)
        g = p.Group(sb)
        offs, pos = [], view.offset
        for ln in lines:
            offs.append(pos)
            pos += len(ln) + 1
        g.set_columns(p.models.ColumnarLogs(
            np.array(offs, np.int32),
            np.array([len(x) for x in lines], np.int32),
            np.full(len(lines), 1700000000, np.int64)))
        agg = p.agg(cls, {})
        out.append((describe(agg.add(g), [g]), describe(agg.flush(), [g])))
        got[name] = out
    assert got["port"] == got["ref"]


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregator_case_matches_reference(case):
    got = CASES[case](Pkg("port"))
    want = CASES[case](Pkg("ref"))
    assert got == want


NAMES = ["aggregator_base", "aggregator_context", "aggregator_metadata_group",
         "aggregator_shardhash", "aggregator_content_value_group",
         "aggregator_logstore_router", "aggregator_opentelemetry",
         "aggregator_skywalking", "aggregator_default",
         "aggregator_metric_rollup"]


@pytest.mark.parametrize("name", NAMES)
def test_registered_under_the_reference_name(name):
    port, ref = PluginRegistry.instance(), RefRegistry.instance()
    port.load_static_plugins()
    ref.load_static_plugins()
    a, b = port.create_aggregator(name), ref.create_aggregator(name)
    assert a is not None and b is not None
    assert type(a).__name__ == type(b).__name__


def test_metadata_group_agents_agree(tmp_path):
    lines = td.gen_app_lines(3000, seed=21)
    log = tmp_path / "app.log"
    log.write_bytes(b"\n".join(lines) + b"\n")
    outs = {}
    for who in ("ref", "port"):
        cfg_dir = tmp_path / f"cfg_{who}"
        cfg_dir.mkdir()
        outs[who] = tmp_path / f"out_{who}.json"
        (cfg_dir / "es.yaml").write_text(
            td.metadata_group_config(str(log), str(outs[who])))
        if who == "ref":
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
            subprocess.run([sys.executable, "-m", "loongcollector_tpu",
                            "--config", str(cfg_dir), "--once",
                            "--data-dir", str(tmp_path / "ref_data")],
                           cwd=str(tmp_path), env=env, check=True,
                           capture_output=True, timeout=600)
        else:
            from loongcollector_tpu_torch.application import main
            assert main(["--config", str(cfg_dir), "--once", "--cpu",
                         "--data-dir", str(tmp_path / "port_data"),
                         "--stats", str(tmp_path / "stats.json")]) == 0
    got = sorted(_TIME.sub(b"\"__time__\": 0", x) for x in outs["port"].read_bytes()
                 .splitlines())
    want = sorted(_TIME.sub(b"\"__time__\": 0", x) for x in outs["ref"].read_bytes()
                  .splitlines())
    assert got == want and len(got) == len(lines)
    rows = sorted(tuple(json.loads(x)[k] for k in ("app", "action",
                                                     "latency_ms"))
                  for x in got)
    assert rows == sorted(tuple(x.decode().split(" ")) for x in lines)
    with open(tmp_path / "stats.json") as f:
        st = json.load(f)
    assert st["stage_seconds"]["aggregator_metadata_group"] > 0
