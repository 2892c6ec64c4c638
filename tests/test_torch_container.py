"""Container stdout: the port's container discovery, ``input_container_stdio``,
``processor_parse_container_log_native``,
``processor_merge_multiline_log_native``, ``processor_tag_native``,
``flusher_loki`` and ``input_internal_matched_container_info`` against the
JAX package's, on the CPU.

* Discovery over a tmp kubelet pod-log tree (``LOONG_CRI_POD_LOG_DIR``), a
  tmp Docker socket (an HTTP server on ``AF_UNIX``), a tmp CRI gRPC socket
  (``ListContainers`` answered with hand-built protobuf bytes) and a tmp
  apiserver (pod labels, services): both managers see the same
  containers, and their diffs, filters and metadata agree; the protobuf
  field reader agrees on random and truncated bytes.  Every source is
  pointed at ``tmp_path`` (no host socket is read), and both packages'
  ``ContainerManager`` singletons are reset around every test.
* ``input_container_stdio``: the same inner processors, matched paths and
  per-path tags (``_namespace_``, ``_pod_name_``, ``pod.label.*``, ...).
* The CRI and docker json-file unwraps, the flag and regex merges, the tag
  processor (host name and IP pinned on both sides) and the Loki push
  payload: equal columns, events, tags and bytes.
* ``input_internal_matched_container_info``: the same diff events.
* The container config end to end: the JAX agent and the port's ``--cpu``
  agent, both in tail mode, on one tmp tree, push the same Loki records,
  and those are what the unwrap and the flag merge make of the tree
  (``testdata.cri_merged``).
"""

import json
import os
import random
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import http.server
from concurrent import futures

import numpy as np
import pytest
import torch

from conftest import wait_for
from loongcollector_tpu import container_manager as ref_cm
from loongcollector_tpu.flusher.loki import FlusherLoki as RefLoki
from loongcollector_tpu.input import container_stdio as ref_stdio
from loongcollector_tpu.input import internal as ref_internal
from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.models import SourceBuffer as RefSourceBuffer
from loongcollector_tpu.monitor.self_monitor import \
    SelfMonitorServer as RefSelfMonitor
from loongcollector_tpu.pipeline.plugin.interface import \
    PluginContext as RefContext
from loongcollector_tpu.processor import merge_multiline as ref_merge
from loongcollector_tpu.processor import parse_container_log as ref_pcl
from loongcollector_tpu.processor import tag as ref_tag
from loongcollector_tpu.processor.parse_regex import \
    ProcessorParseRegex as RefParse
from loongcollector_tpu.processor.split_log_string import \
    ProcessorSplitLogString as RefSplit
from loongcollector_tpu_torch import container_manager as port_cm
from loongcollector_tpu_torch import testdata as td
from loongcollector_tpu_torch.flusher.loki import FlusherLoki
from loongcollector_tpu_torch.input import container_stdio as port_stdio
from loongcollector_tpu_torch.input import internal as port_internal
from loongcollector_tpu_torch.models import PipelineEventGroup, SourceBuffer
from loongcollector_tpu_torch.monitor.self_monitor import SelfMonitorServer
from loongcollector_tpu_torch.pipeline.plugin.interface import PluginContext
from loongcollector_tpu_torch.processor import merge_multiline as port_merge
from loongcollector_tpu_torch.processor import parse_container_log as port_pcl
from loongcollector_tpu_torch.processor import tag as port_tag
from loongcollector_tpu_torch.processor.parse_regex import ProcessorParseRegex
from loongcollector_tpu_torch.processor.split_log_string import \
    ProcessorSplitLogString
from test_torch_alarms import alarms_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": dict(Group=RefGroup, Buf=RefSourceBuffer, Split=RefSplit,
                Parse=RefParse, cm=ref_cm, stdio=ref_stdio, pcl=ref_pcl,
                merge=ref_merge, tag=ref_tag, Loki=RefLoki,
                internal=ref_internal, Monitor=RefSelfMonitor,
                Ctx=lambda: RefContext("p")),
    "port": dict(Group=PipelineEventGroup, Buf=SourceBuffer,
                 Split=ProcessorSplitLogString, Parse=ProcessorParseRegex,
                 cm=port_cm, stdio=port_stdio, pcl=port_pcl,
                 merge=port_merge, tag=port_tag, Loki=FlusherLoki,
                 internal=port_internal, Monitor=SelfMonitorServer,
                 Ctx=lambda: PluginContext("p", device=torch.device("cpu"))),
}


def reset_container_managers() -> None:
    """Both packages' ``ContainerManager`` singletons stopped and dropped
    (the JAX package's has no reset of its own)."""
    ref = ref_cm.ContainerManager._instance
    if ref is not None:
        ref.set_on_diff(None)
        ref.k8s.stop_watch()
        for t in (ref._thread, ref.k8s._watch_thread):
            if t is not None:
                t.join(timeout=15)
    ref_cm.ContainerManager._instance = None
    port_cm.ContainerManager.reset_for_testing()


@pytest.fixture(autouse=True, scope="module")
def containers_left_empty():
    """At the end of the module that imports it: both packages'
    ``ContainerManager`` singletons stopped and dropped."""
    yield
    reset_container_managers()


def snapshot(group):
    """The group's columns (content, fields, timestamps) or its events'
    contents, as bytes."""
    cols = group.columns
    if cols is None or group._events:
        return [(getattr(ev, "timestamp", None),
                 [(k.to_bytes(), v.to_bytes()) for k, v in ev.contents])
                if hasattr(ev, "contents") else type(ev).__name__
                for ev in group.events]
    arena = group.source_buffer.as_array()

    def col(offs, lens):
        return [bytes(arena[int(o): int(o) + int(n)].tobytes())
                if n >= 0 else None for o, n in zip(offs, lens)]
    out = {"content": col(cols.offsets, cols.lengths),
           "content_consumed": cols.content_consumed,
           "timestamps": cols.timestamps.tolist()}
    for name, (offs, lens) in sorted(cols.fields.items()):
        out[name] = col(offs, lens)
    return out



@pytest.fixture(autouse=True)
def containers_reset(monkeypatch, tmp_path):
    """Every discovery source at ``tmp_path`` (a pod-log root, a Docker
    socket path nothing listens on, no CRI socket, no in-cluster
    apiserver); both managers reset before and after."""
    monkeypatch.setenv("LOONG_CRI_POD_LOG_DIR", str(tmp_path / "pods"))
    monkeypatch.setenv("LOONG_DOCKER_SOCK", str(tmp_path / "docker.sock"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for cm in (ref_cm, port_cm):
        monkeypatch.setattr(cm, "CRI_SOCKETS", ())
        monkeypatch.setattr(cm.CRISocketDiscovery.__init__, "__defaults__",
                            ((),))
    reset_container_managers()
    yield
    reset_container_managers()


def _managers():
    return {pkg: PKGS[pkg]["cm"].ContainerManager.instance()
            for pkg in ("ref", "port")}


def _info_dicts(infos):
    from dataclasses import asdict
    return sorted((asdict(i) for i in infos), key=lambda d: json.dumps(
        d, sort_keys=True))


# -- fake sources ---------------------------------------------------------------

class _UnixHTTPServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True


def docker_server(path, containers):
    """An HTTP server on the unix socket ``path`` answering
    ``/containers/json`` with ``containers``."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(containers).encode() \
                if self.path == "/containers/json" else b"[]"
            self.send_response(200 if self.path == "/containers/json"
                               else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def address_string(self):
            return "unix"

        def log_message(self, *args):
            pass

    srv = _UnixHTTPServer(str(path), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def apiserver(pods, services):
    """A plain-HTTP apiserver on 127.0.0.1: pod GETs by namespace/name and
    service lists by namespace."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            parts = self.path.strip("/").split("/")
            body = None
            if len(parts) == 6 and parts[4] == "pods":
                pod = pods.get((parts[3], parts[5]))
                if pod is not None:
                    body = {"metadata": {"labels": pod},
                            "spec": {"nodeName": "node-1"},
                            "status": {"podIP": "10.0.0.7"}}
            elif len(parts) == 5 and parts[4] == "services":
                body = {"items": [
                    {"metadata": {"name": n}, "spec": {
                        "selector": sel, "clusterIP": "10.96.0.1"}}
                    for n, sel in services.get(parts[3], [])]}
            data = json.dumps(body).encode() if body is not None else b"{}"
            self.send_response(200 if body is not None else 404)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field, payload):
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def cri_container(cid, name, image, labels, state=1):
    """A CRI ``Container`` message: id, metadata.name, image.image, state,
    labels (map entries)."""
    msg = _ld(1, cid.encode()) + _ld(2, b"sandbox")
    msg += _ld(3, _ld(1, name.encode()) + _varint(2 << 3) + _varint(0))
    msg += _ld(4, _ld(1, image.encode()))
    msg += _varint(6 << 3) + _varint(state)
    msg += _varint(7 << 3 | 1) + (1700000000).to_bytes(8, "little")
    for k, v in labels.items():
        msg += _ld(8, _ld(1, k.encode()) + _ld(2, v.encode()))
    return msg


def cri_server(path, containers):
    """A gRPC server on the unix socket ``path`` answering
    ``runtime.v1.RuntimeService/ListContainers`` with ``containers``."""
    import grpc
    body = b"".join(_ld(1, c) for c in containers)
    handler = grpc.method_handlers_generic_handler(
        "runtime.v1.RuntimeService",
        {"ListContainers": grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: body, request_deserializer=None,
            response_serializer=None)})
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    srv.add_generic_rpc_handlers((handler,))
    srv.add_insecure_port(f"unix:{path}")
    srv.start()
    return srv


@pytest.fixture
def sock_dir():
    """A directory whose paths are short enough for a unix socket's
    ``sun_path`` (a test's tmp dir may not be); removed after."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="lct", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# -- discovery ---------------------------------------------------------------------

DOCKER = [
    {"Id": "a" * 64, "Names": ["/web-0"], "Image": "nginx:1.25",
     "Labels": {"io.kubernetes.pod.namespace": "prod-web",
                "io.kubernetes.pod.name": "web-0",
                "io.kubernetes.container.name": "app",
                "team": "payments"}},
    {"Id": "b" * 64, "Names": ["/sidecar"], "Image": "envoy:1.29",
     "Labels": {"tier": "edge"}},
    {"Id": "c" * 64, "Names": None, "Image": "busybox", "Labels": None},
]


def _tree(tmp_path, lines=20):
    return td.write_cri_tree(str(tmp_path / "pods"), n_prod=3, n_other=1,
                             lines_per_pod=lines, seed=2, partial=0.2)


def test_discovery_merges_sources_like_the_reference(tmp_path, sock_dir,
                                                     monkeypatch):
    sock = os.path.join(sock_dir, "docker.sock")
    monkeypatch.setenv("LOONG_DOCKER_SOCK", sock)
    _tree(tmp_path)
    # a directory that is not a pod, and a pod dir holding a plain file
    (tmp_path / "pods" / "not-a-pod").mkdir()
    (tmp_path / "pods" / "ns_pod_uid").mkdir()
    (tmp_path / "pods" / "ns_pod_uid" / "stray.txt").write_text("x")
    docker = docker_server(sock, DOCKER)
    api = apiserver({("prod-web", "web-0"): {"app": "web", "track": "canary"},
                     ("prod-web", "web-1"): {"app": "web"}},
                    {"prod-web": [("web", {"app": "web"}),
                                  ("canary", {"track": "canary"}),
                                  ("none", {})]})
    try:
        found = {}
        for pkg, mgr in _managers().items():
            mgr.k8s.configure("http", "127.0.0.1", api.server_address[1])
            found[pkg] = mgr.discover()
            found[pkg + "_svc"] = mgr.k8s.services_for_pod("prod-web",
                                                           "web-0")
            found[pkg + "_meta"] = mgr.k8s.pod_metadata("prod-web", "web-1")
            found[pkg + "_miss"] = mgr.k8s.pod_metadata("prod-web", "nope")
            found[pkg + "_svcs"] = mgr.k8s.service_metadata("prod-web")
        assert _info_dicts(found["port"]) == _info_dicts(found["ref"])
        for k in ("svc", "meta", "miss", "svcs"):
            assert found[f"port_{k}"] == found[f"ref_{k}"], k
        infos = {i.stable_key: i for i in found["port"]}
        # the docker container of pod web-0 and its pod-log dir are one
        assert len(infos) == 4 + 2
        assert infos["prod-web/web-0/app"].labels["pod.label.track"] == \
            "canary"
        assert sorted(found["port_svc"]) == ["canary", "web"]
    finally:
        docker.shutdown()
        docker.server_close()
        api.shutdown()
        api.server_close()


def test_cri_socket_discovery_matches_reference(tmp_path, sock_dir):
    path = os.path.join(sock_dir, "cri.sock")
    labels = {"io.kubernetes.pod.namespace": "prod-web",
              "io.kubernetes.pod.name": "web-9",
              "io.kubernetes.pod.uid": "u-9",
              "io.kubernetes.container.name": "app"}
    srv = cri_server(path, [
        cri_container("c1", "app", "nginx:1.25", labels),
        cri_container("c2", "exited", "busybox", {}, state=2),
        cri_container("c3", "plain", "redis:7", {"x": "y"}),
    ])
    try:
        got = {}
        for pkg in ("ref", "port"):
            d = PKGS[pkg]["cm"].CRISocketDiscovery(sockets=())
            d.socket_override = path
            got[pkg] = d.list_containers()
        assert _info_dicts(got["port"]) == _info_dicts(got["ref"])
        assert sorted(i.id for i in got["port"]) == ["c1", "c3"]
        (c1,) = [i for i in got["port"] if i.id == "c1"]
        assert c1.log_path == os.path.join(
            str(tmp_path / "pods"), "prod-web_web-9_u-9", "app", "*.log")
    finally:
        srv.stop(0)


@pytest.mark.parametrize("seed", range(6))
def test_pb_fields_match_reference(seed):
    rng = random.Random(seed)
    good = b"".join(_ld(1, cri_container(
        f"id{i}", f"n{i}", "img", {f"k{j}": f"v{j}" for j in range(i)}))
        for i in range(4))
    cases = [good, good[:-3], good[: len(good) // 2],
             bytes(rng.randrange(256) for _ in range(200)),
             _varint(3 << 3 | 5) + b"\x01\x02\x03\x04"
             + _varint(4 << 3 | 1) + bytes(8) + _varint(5 << 3 | 3),
             b"\xff" * 12, b""]
    for buf in cases:
        assert port_cm.pb_fields(buf) == ref_cm.pb_fields(buf)
    entries = port_cm.pb_fields(good)[1]
    for e in entries:
        m = port_cm.pb_fields(e).get(8, [])
        assert port_cm._pb_map(m) == ref_cm._pb_map(m)


FILTERS = [
    {}, {"K8sNamespaceRegex": "prod.*"}, {"K8sPodRegex": "web-[01]"},
    {"IncludeContainerLabel": {"team": "pay*"}},
    {"ExcludeContainerLabel": {"tier": "edge"}},
    {"K8sNamespaceRegex": "kube-.*", "ExcludeContainerLabel": {"x": "*"}},
]


@pytest.mark.parametrize("cfg", FILTERS, ids=lambda c: json.dumps(c))
def test_filters_match_reference(cfg):
    infos = []
    for pkg in ("ref", "port"):
        cm = PKGS[pkg]["cm"]
        infos.append([cm.ContainerInfo(
            id=f"id{i}", name=f"c{i}", labels=labels, k8s_namespace=ns,
            k8s_pod=pod)
            for i, (ns, pod, labels) in enumerate([
                ("prod-web", "web-0", {"team": "payments"}),
                ("prod-web", "web-1", {"tier": "edge"}),
                ("kube-system", "dns-0", {"x": "1"}),
                ("", "", {"team": "search"}), ("staging", "web-0", {})])])
    ref, port = infos
    f_ref, f_port = ref_cm.ContainerFilters(cfg), port_cm.ContainerFilters(cfg)
    assert [f_port.match(i) for i in port] == [f_ref.match(i) for i in ref]


def test_diff_rounds_match_reference(tmp_path):
    tree = _tree(tmp_path)
    seen = {"ref": [], "port": []}
    answer = {"ok": False}

    def consumer(pkg):
        def on_diff(added, removed):
            seen[pkg].append((sorted(c.stable_key for c in added),
                              sorted(c.stable_key for c in removed)))
            return answer["ok"]
        return on_diff

    mgrs = _managers()
    for pkg, mgr in mgrs.items():
        mgr.on_diff = consumer(pkg)
    for step in range(4):
        if step == 1:
            answer["ok"] = True          # the refused diff is re-emitted
        if step == 2:
            os.rename(os.path.dirname(next(iter(tree))),
                      str(tmp_path / "gone"))
        if step == 3:
            d = tmp_path / "pods" / "prod-web_web-new_u1" / "app"
            d.mkdir(parents=True)
        for mgr in mgrs.values():
            mgr.diff_round()
    assert seen["port"] == seen["ref"]
    assert len(seen["port"]) == 4 and seen["port"][0] == seen["port"][1]


def test_watch_events_apply_like_the_reference():
    events = [{"type": "ADDED", "object": {"metadata": {
        "namespace": "ns", "name": "p", "labels": {"a": "1"}},
        "spec": {"nodeName": "n"}, "status": {"podIP": "1.2.3.4"}}},
        {"type": "MODIFIED", "object": {"metadata": {
            "namespace": "ns", "name": "p", "labels": {"a": "2"}}}},
        {"type": "ADDED", "object": {"metadata": {"namespace": "ns",
                                                  "name": "q"}}},
        {"type": "DELETED", "object": {"metadata": {"namespace": "ns",
                                                    "name": "q"}}},
        {"type": "ADDED", "object": {}}]
    caches = {}
    for pkg in ("ref", "port"):
        k8s = PKGS[pkg]["cm"].K8sMetadata()
        for ev in events:
            k8s._apply_watch_event(json.dumps(ev).encode())
        k8s._apply_watch_event(b"not json")
        caches[pkg] = {k: v[0] for k, v in k8s._cache.items()}
    assert caches["port"] == caches["ref"] == {
        "ns/p": {"labels": {"a": "2"}, "node": "", "ip": ""}}


# -- input_container_stdio ------------------------------------------------------

STDIO_CONFIGS = [
    {"ContainerFilters": {"K8sNamespaceRegex": "prod.*"}},
    {"K8sPodRegex": "web-1", "IgnoringStderr": True,
     "Multiline": {"StartPattern": r"\d+\.\d+.*"}},
    {"Format": "docker_json-file", "IgnoringStdout": True},
]


@pytest.mark.parametrize("cfg", STDIO_CONFIGS, ids=range(len(STDIO_CONFIGS)))
def test_stdio_paths_tags_and_inner_chain(cfg, tmp_path):
    tree = _tree(tmp_path)
    api = apiserver({("prod-web", "web-1"): {"app": "web"}}, {})
    try:
        out = {}
        for pkg in ("ref", "port"):
            mgr = PKGS[pkg]["cm"].ContainerManager.instance()
            mgr.k8s.configure("http", "127.0.0.1", api.server_address[1])
            inp = PKGS[pkg]["stdio"].InputContainerStdio()
            assert inp.init(cfg, PKGS[pkg]["Ctx"]())
            paths = inp._matched_paths()
            tags = {p: inp._tags_for(p) for p in sorted(tree)}
            tags["/elsewhere/0.log"] = inp._tags_for("/elsewhere/0.log")
            out[pkg] = (inp.inner_processor_configs(), paths, tags)
        assert out["port"] == out["ref"]
        assert out["port"][1]
    finally:
        api.shutdown()
        api.server_close()


# -- the unwrap, the merges, the tag processor -----------------------------------

def _split(pkg, data):
    P = PKGS[pkg]
    sb = P["Buf"](len(data) + 64)
    g = P["Group"](sb)
    g.add_raw_event(100).set_content(sb.copy_string(data))
    sp = P["Split"]()
    sp.init({}, P["Ctx"]())
    sp.process(g)
    return g


def _docker_lines(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for i, rec in enumerate(td.gen_lines(n, seed=seed)):
        obj = {"log": rec.decode() + ("\n" if i % 3 else ""),
               "stream": "stderr" if rng.random() < 0.3 else "stdout",
               "time": "2024-01-02T03:04:05.123456789Z"}
        if i % 17 == 5:
            obj = {"log": "café ✓ \"quoted\"\t\n", "time": "t"}
        out.append(json.dumps(obj).encode())
    out += [b"not json", b'{"log": 3}'[:-1]]
    return out


def _cri_data(seed):
    lines = td.cri_lines(td.gen_lines(120, seed=seed), seed=seed,
                         partial=0.25)
    lines += [b"no-spaces", b"2024 stdout", b"2024 other F x",
              b"2024 stderr X odd-flag", b"2024 stdout P", b""]
    return b"\n".join(lines) + b"\n"


PCL_CASES = [
    ("containerd_text", {}), ("containerd_text", {"IgnoringStdout": True}),
    ("containerd_text", {"IgnoringStderr": True, "KeepTimestamp": True}),
    ("docker_json-file", {}), ("docker_json-file", {"IgnoringStderr": True}),
]


@pytest.mark.parametrize("fmt,opts", PCL_CASES,
                         ids=[f"{f}-{sorted(o)}" for f, o in PCL_CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_unwrap_and_flag_merge_match_reference(fmt, opts, seed):
    if fmt == "containerd_text":
        data = _cri_data(seed)
    else:
        data = b"\n".join(_docker_lines(seed)) + b"\n"
    got = {}
    for pkg in ("ref", "port"):
        P = PKGS[pkg]
        g = _split(pkg, data)
        pcl = P["pcl"].ProcessorParseContainerLog()
        assert pcl.init(dict(opts, Format=fmt), P["Ctx"]())
        pcl.process(g)
        unwrapped = snapshot(g)
        merge = P["merge"].ProcessorMergeMultilineLog()
        assert merge.init({"MergeType": "flag"}, P["Ctx"]())
        merge.process(g)
        got[pkg] = (unwrapped, snapshot(g))
    assert got["port"] == got["ref"]


def test_flag_merge_matches_the_chunk_model():
    """The port's unwrap + flag merge on reader chunks of a CRI log give
    ``testdata.cri_merged``'s records (a ``P`` run cut by a chunk
    boundary ships in two)."""
    lines = td.cri_lines(td.gen_lines(3000, seed=4), seed=4, partial=0.2)
    chunk = 4096
    want = td.cri_merged(lines, chunk_size=chunk)
    got = []
    for piece in td.reader_chunks(lines, chunk):
        g = _split("port", b"\n".join(piece) + b"\n")
        for cls, cfg in ((port_pcl.ProcessorParseContainerLog, {}),
                         (port_merge.ProcessorMergeMultilineLog,
                          {"MergeType": "flag"})):
            p = cls()
            p.init(cfg, PKGS["port"]["Ctx"]())
            p.process(g)
        snap = snapshot(g)
        got += list(zip(snap["_source_"], snap["content"]))
    assert got == [(s, c) for s, c, _split_ in want]
    assert sum(s for *_x, s in want) > 0


@pytest.mark.parametrize("multiline", [
    {"StartPattern": td.JAVA_START},
    {"StartPattern": td.JAVA_START, "ContinuePattern": td.JAVA_CONTINUE},
    {"StartPattern": td.JAVA_START, "UnmatchedContentTreatment": "discard"},
])
def test_regex_merge_matches_reference(multiline, monkeypatch):
    monkeypatch.setenv("LOONG_DEVICE_MIN_BYTES", str(1 << 40))
    data = b"\n".join(td.gen_java_log(400, seed=6)) + b"\n"
    got = {}
    for pkg in ("ref", "port"):
        P = PKGS[pkg]
        g = _split(pkg, data)
        merge = P["merge"].ProcessorMergeMultilineLog()
        assert merge.init(dict(multiline, MergeType="regex"), P["Ctx"]())
        merge.process(g)
        got[pkg] = snapshot(g)
    assert got["port"] == got["ref"]


TAG_CASES = [
    {}, {"PipelineMetaTagKey": {"HOST_NAME": "hostname", "HOST_IP": ""}},
    {"PipelineMetaTagKey": {"HOST_IP": "__default__",
                            "HOST_NAME": "__default__"},
     "AgentEnvMetaTagKey": {"cluster": "c1", "zone": "z"}},
]


@pytest.mark.parametrize("cfg", TAG_CASES, ids=range(len(TAG_CASES)))
def test_tag_processor_matches_reference(cfg, monkeypatch):
    monkeypatch.setattr(socket, "gethostname", lambda: "node-7")
    monkeypatch.setattr(socket, "gethostbyname", lambda h: "10.1.2.3")
    got = {}
    for pkg in ("ref", "port"):
        P = PKGS[pkg]
        p = P["tag"].ProcessorTag()
        assert p.init(cfg, P["Ctx"]())
        g = _split(pkg, b"a\nb\n")
        g.set_tag("keep", "me")
        p.process(g)
        got[pkg] = sorted((k, bytes(v)) for k, v in g.tags.items())
    assert got["port"] == got["ref"]
    assert (b"keep", b"me") in got["port"]


# -- flusher_loki ------------------------------------------------------------------

LOKI_CONFIGS = [
    {"URL": "http://loki:3100/", "TenantID": "team-a",
     "StaticLabels": {"job": "loongcollector"},
     "DynamicLabels": ["_namespace_", "_pod_name_", "level-name", "9x"]},
    {"URL": "http://loki:3100", "DynamicLabels": ["method"],
     "Authentication": {"PlainText": {"Username": "u", "Password": "p"}}},
    {"URL": ""},
]


def _loki_groups(pkg):
    P = PKGS[pkg]
    lines = td.gen_lines(40, seed=12)
    g1 = _split(pkg, b"\n".join(lines) + b"\n")
    pr = P["Parse"]()
    pr.init({"SourceKey": "content", "Regex": td.APACHE,
             "Keys": td.APACHE_KEYS}, P["Ctx"]())
    pr.process(g1)
    g1.set_tag("_namespace_", "prod-web")
    g1.set_tag("_pod_name_", "web-0")
    g2 = _split(pkg, "plain ✓ line\nother\n".encode())
    g2.set_tag("level-name", "info")
    g3 = P["Group"]()
    sb = g3.source_buffer
    for i in range(3):
        ev = g3.add_log_event(1700000000 + i)
        ev.set_content(b"content", sb.copy_string(f"only {i}"))
        if i:
            ev.set_content(b"9x", sb.copy_string("nine"))
    g3.set_tag("_pod_name_", "web-1")
    return [g1, g2, g3]


@pytest.mark.parametrize("cfg", LOKI_CONFIGS, ids=range(len(LOKI_CONFIGS)))
def test_loki_payload_bytes_match_reference(cfg):
    got = {}
    for pkg in ("ref", "port"):
        f = PKGS[pkg]["Loki"]()
        ok = f._init_sink(cfg)
        got[pkg] = (ok, f.build_payload(_loki_groups(pkg)) if ok else None,
                    f.endpoint_url(None) if ok else None)
        got[pkg + "_empty"] = f.build_payload([]) if ok else None
    assert got["port"] == got["ref"]
    assert got["port_empty"] == got["ref_empty"] is None or not got["port"][0]


# -- input_internal_matched_container_info ----------------------------------------

class _Queues:
    def __init__(self, accept=True):
        self.accept = accept
        self.groups = []

    def push_queue(self, key, group):
        if self.accept:
            self.groups.append(group)
        return self.accept


def test_matched_container_info_matches_reference(tmp_path):
    _tree(tmp_path)
    got = {}
    for pkg in ("ref", "port"):
        P = PKGS[pkg]
        mon = P["Monitor"].instance()
        queues = _Queues()
        mon.process_queue_manager = queues
        inp = P["internal"].InputInternalMatchedContainerInfo()
        ctx = P["Ctx"]()
        ctx.process_queue_key = 7
        assert inp.init({}, ctx)
        assert inp.start()
        # a second binding of the diff consumer is refused
        other = P["internal"].InputInternalMatchedContainerInfo()
        other.init({}, ctx)
        assert not other.start()
        assert wait_for(lambda q=queues: len(q.groups) == 1, 30.0)
        inp.stop()
        mgr = P["cm"].ContainerManager.instance()
        assert mgr.on_diff is None
        (g,) = queues.groups
        got[pkg] = (sorted(sorted((k.to_bytes(), v.to_bytes())
                                  for k, v in ev.contents)
                           for ev in g.events),
                    sorted((bytes(k), bytes(v)) for k, v in g.tags.items()))
        if pkg == "port":
            assert inp.groups_pushed == 1
        mon.process_queue_manager = None
        P["Monitor"]._instance = None
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 4


# -- end to end: both agents in tail mode on one tree -----------------------------

def _spawn(who, cfg_dir, data_dir, env):
    pkg = "loongcollector_tpu_torch" if who == "port" else \
        "loongcollector_tpu"
    cmd = [sys.executable, "-m", pkg, "--config", str(cfg_dir),
           "--data-dir", str(data_dir)]
    if who == "port":
        cmd.append("--cpu")
    return subprocess.Popen(cmd, cwd=str(cfg_dir), env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def test_container_agents_agree_end_to_end(tmp_path):
    import chip_smoke
    tree = td.write_cri_tree(str(tmp_path / "pods"), n_prod=3, n_other=1,
                             lines_per_pod=1500, seed=9, partial=0.05)
    want = []
    for path, (ns, pod, lines, _recs) in sorted(tree.items()):
        if ns == td.CRI_NAMESPACE:
            want += [(ns, pod, stream, _record_key(content))
                     for stream, content, _s in td.cri_merged(lines)]
    recv = {w: chip_smoke.LokiReceiver().start() for w in ("ref", "port")}
    procs = []
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               LOONG_CRI_POD_LOG_DIR=str(tmp_path / "pods"),
               LOONG_DOCKER_SOCK=str(tmp_path / "docker.sock"))
    env.pop("KUBERNETES_SERVICE_HOST", None)
    try:
        for who in ("ref", "port"):
            cfg = tmp_path / f"cfg_{who}"
            cfg.mkdir()
            (cfg / "stdio.yaml").write_text(
                td.container_loki_config(recv[who].url))
            procs.append((who, _spawn(who, cfg, tmp_path / f"data_{who}",
                                      env)))
        assert wait_for(lambda: all(r.count() >= len(want)
                                    for r in recv.values()), 180.0), \
            {w: r.count() for w, r in recv.items()}
        for who, p in procs:
            p.send_signal(signal.SIGTERM)
            _out, err = p.communicate(timeout=60)
            assert p.returncode == 0, (who, err.decode(errors="replace")
                                       [-3000:])
    finally:
        for _who, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            if p.stderr is not None:
                p.stderr.close()
        for r in recv.values():
            r.stop()
    recs = {}
    for who, r in recv.items():
        assert r.bad_paths == []
        assert all(h.get("X-Scope-OrgID") == "team-a" for h in r.headers)
        recs[who] = sorted((labels, line) for labels, _ts, line
                           in r.records())
    assert recs["port"] == recs["ref"]
    got = []
    for labels, line in recs["port"]:
        lab = dict(labels)
        assert lab["job"] == "loongcollector"
        obj = json.loads(line)
        if all(k in obj for k in td.APACHE_KEYS):
            key = ("parsed", tuple(obj[k] for k in td.APACHE_KEYS))
        else:
            key = ("raw", (obj.get("content") or obj["rawLog"]).encode())
        got.append((lab["_namespace_"], lab["_pod_name_"],
                    obj["_source_"].encode(), key))
    assert sorted(got) == sorted(want)


def _record_key(content):
    """A record as the sink shows it: the Apache fields ``re`` gives the
    content, else the content itself."""
    m = td.apache_oracle([content])[0]
    if m is None:
        return ("raw", content)
    return ("parsed", tuple(m[k] for k in td.APACHE_KEYS))
