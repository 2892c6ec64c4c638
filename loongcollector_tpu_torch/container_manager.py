"""Container discovery & metadata.

Reference: core/container_manager/ (discovery diffing; pushes matched-
container info, triggers FileServer pause/resume on changes,
ContainerManager.cpp:325) and core/metadata/ (K8sMetadata pod/service cache).

Discovery sources:
  * Docker Engine API over /var/run/docker.sock (stdlib HTTP over AF_UNIX)
  * CRI log directory layout (/var/log/pods/<ns>_<pod>_<uid>/<container>/)
  * static container info files (the reference's mounted containerInfo)

The FileServer consumes discovery results as extra glob roots; label/env
filters follow the reference's ContainerFilters config shape.

The port's copy of the JAX package's ``container_manager.py``.  Each source
is resolved when the manager is built: ``LOONG_DOCKER_SOCK`` (default
``/var/run/docker.sock``), ``LOONG_CRI_POD_LOG_DIR`` (default
``/var/log/pods``) and the CRI sockets (the CRI socket source needs the
``grpc`` package and reports nothing without it).  ``reset_for_testing``
stops the diff thread and drops the singleton.
"""

from __future__ import annotations

import fnmatch
import http.client
import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .utils.logger import get_logger

log = get_logger("container_manager")

DOCKER_SOCK = "/var/run/docker.sock"
CRI_POD_LOG_DIR = "/var/log/pods"


@dataclass
class ContainerInfo:
    id: str = ""
    name: str = ""
    image: str = ""
    log_path: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    k8s_namespace: str = ""
    k8s_pod: str = ""
    k8s_container: str = ""

    @property
    def stable_key(self) -> str:
        """Identity stable ACROSS discovery sources: the CRI socket and the
        pod-log-dir walk report different ids for the same container, so
        diffing by raw id would flap when one source has a bad round."""
        if self.k8s_pod:
            return f"{self.k8s_namespace}/{self.k8s_pod}/{self.k8s_container or self.name}"
        return f"id/{self.id}"


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float = 5.0):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._sock_path)
        self.sock = s


class DockerDiscovery:
    """List running containers via the Docker Engine API."""

    def __init__(self, sock_path: Optional[str] = None):
        # resolved at construction (env override for non-standard sockets
        # and test fixtures), not at class-definition time
        self.sock_path = sock_path or os.environ.get(
            "LOONG_DOCKER_SOCK", DOCKER_SOCK)

    def available(self) -> bool:
        return os.path.exists(self.sock_path)

    def list_containers(self) -> List[ContainerInfo]:
        if not self.available():
            return []
        try:
            conn = _UnixHTTPConnection(self.sock_path)
            conn.request("GET", "/containers/json")
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            if resp.status != 200:
                return []
            data = json.loads(body)
        except (OSError, ValueError, http.client.HTTPException):
            return []
        if not isinstance(data, list):
            return []
        out = []
        for c in data:
            cid = c.get("Id", "")
            info = ContainerInfo(
                id=cid,
                name=(c.get("Names") or [""])[0].lstrip("/"),
                image=c.get("Image", ""),
                labels=c.get("Labels") or {},
                log_path=f"/var/lib/docker/containers/{cid}/{cid}-json.log")
            labels = info.labels
            info.k8s_namespace = labels.get("io.kubernetes.pod.namespace", "")
            info.k8s_pod = labels.get("io.kubernetes.pod.name", "")
            info.k8s_container = labels.get("io.kubernetes.container.name", "")
            out.append(info)
        return out


class CRIDiscovery:
    """Discover container stdout logs from the kubelet pod-log layout."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "LOONG_CRI_POD_LOG_DIR", CRI_POD_LOG_DIR)

    def available(self) -> bool:
        return os.path.isdir(self.root)

    def list_containers(self) -> List[ContainerInfo]:
        out = []
        if not self.available():
            return out
        try:
            pods = os.listdir(self.root)
        except OSError:
            return out
        for pod_dir in pods:
            parts = pod_dir.split("_")
            if len(parts) != 3:
                continue
            ns, pod, uid = parts
            pod_path = os.path.join(self.root, pod_dir)
            try:
                containers = os.listdir(pod_path)
            except OSError:
                continue
            for cname in containers:
                cdir = os.path.join(pod_path, cname)
                if not os.path.isdir(cdir):
                    continue
                out.append(ContainerInfo(
                    id=f"{uid}/{cname}", name=cname,
                    log_path=os.path.join(cdir, "*.log"),
                    k8s_namespace=ns, k8s_pod=pod, k8s_container=cname))
        return out


def pb_fields(buf: bytes) -> Dict[int, List]:
    """Generic protobuf decoder: field → [value] (bytes for LEN, int for
    VARINT/fixed). Enough to read CRI responses without generated stubs."""
    out: Dict[int, List] = {}
    p, n = 0, len(buf)
    try:
        while p < n:
            v = s = 0
            while True:
                b = buf[p]; p += 1
                v |= (b & 0x7F) << s
                if not b & 0x80:
                    break
                s += 7
            field, wt = v >> 3, v & 7
            if wt == 0:
                v = s = 0
                while True:
                    b = buf[p]; p += 1
                    v |= (b & 0x7F) << s
                    if not b & 0x80:
                        break
                    s += 7
                out.setdefault(field, []).append(v)
            elif wt == 2:
                ln = s = 0
                while True:
                    b = buf[p]; p += 1
                    ln |= (b & 0x7F) << s
                    if not b & 0x80:
                        break
                    s += 7
                if p + ln > n:
                    break  # truncated LEN payload
                out.setdefault(field, []).append(buf[p:p + ln])
                p += ln
            elif wt == 5:
                out.setdefault(field, []).append(
                    int.from_bytes(buf[p:p + 4], "little"))
                p += 4
            elif wt == 1:
                out.setdefault(field, []).append(
                    int.from_bytes(buf[p:p + 8], "little"))
                p += 8
            else:
                break  # unsupported wire type: stop parsing defensively
    except IndexError:
        pass  # truncated varint: keep what parsed cleanly
    return out


def _pb_map(entries: List[bytes]) -> Dict[str, str]:
    out = {}
    for e in entries:
        f = pb_fields(e)
        k = f.get(1, [b""])[0]
        v = f.get(2, [b""])[0]
        out[k.decode("utf-8", "replace")] = (
            v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v))
    return out


CRI_SOCKETS = ("/run/containerd/containerd.sock",
               "/var/run/containerd/containerd.sock",
               "/var/run/crio/crio.sock",
               "/run/k3s/containerd/containerd.sock")
_CONTAINER_RUNNING = 1


class CRISocketDiscovery:
    """CRI runtime API over the containerd/CRI-O socket (gRPC
    runtime.v1.RuntimeService/ListContainers), protobuf hand-decoded.

    Reference: core/container_manager/ talks to the CRI runtime for
    container metadata where Docker's engine API is absent (containerd-only
    nodes — the common K8s case since dockershim's removal).
    """

    def __init__(self, sockets=CRI_SOCKETS):
        self.sockets = [s for s in sockets]
        self.socket_override = None
        self.pod_log_dir = os.environ.get("LOONG_CRI_POD_LOG_DIR",
                                          CRI_POD_LOG_DIR)

    def _socket(self) -> Optional[str]:
        if self.socket_override:
            return self.socket_override
        for s in self.sockets:
            if os.path.exists(s):
                return s
        return None

    def available(self) -> bool:
        return self._socket() is not None

    def list_containers(self) -> List[ContainerInfo]:
        sock = self._socket()
        if sock is None:
            return []
        try:
            import grpc
        except ImportError:
            return []
        target = sock if "://" in sock else f"unix:{sock}"
        ch = None
        try:
            ch = grpc.insecure_channel(target)
            raw = None
            for service in ("runtime.v1.RuntimeService",
                            "runtime.v1alpha2.RuntimeService"):
                call = ch.unary_unary(
                    f"/{service}/ListContainers",
                    request_serializer=lambda x: x,
                    response_deserializer=lambda x: x)
                try:
                    raw = call(b"", timeout=3)
                    break
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                        continue
                    raise
        except Exception:  # noqa: BLE001 — discovery is best-effort
            return []
        finally:
            if ch is not None:
                ch.close()
        if raw is None:
            return []
        out = []
        for cbuf in pb_fields(raw).get(1, []):
            c = pb_fields(cbuf)
            state = c.get(6, [None])[0]
            if state is not None and state != _CONTAINER_RUNNING:
                continue
            labels = _pb_map(c.get(8, []))
            meta = pb_fields(c.get(3, [b""])[0])
            name = meta.get(1, [b""])[0]
            image_spec = pb_fields(c.get(4, [b""])[0])
            info = ContainerInfo(
                id=c.get(1, [b""])[0].decode("utf-8", "replace"),
                name=(name.decode("utf-8", "replace")
                      if isinstance(name, bytes) else ""),
                image=image_spec.get(1, [b""])[0].decode("utf-8", "replace"),
                labels=labels,
                k8s_namespace=labels.get("io.kubernetes.pod.namespace", ""),
                k8s_pod=labels.get("io.kubernetes.pod.name", ""),
                k8s_container=labels.get("io.kubernetes.container.name", ""))
            uid = labels.get("io.kubernetes.pod.uid", "")
            if info.k8s_pod and uid:
                info.log_path = os.path.join(
                    self.pod_log_dir,
                    f"{info.k8s_namespace}_{info.k8s_pod}_{uid}",
                    info.k8s_container or info.name, "*.log")
            out.append(info)
        return out


class ContainerFilters:
    """Reference ContainerFilters: include/exclude by label/env/k8s names."""

    def __init__(self, config: Optional[dict] = None):
        cfg = config or {}
        self.include_labels = cfg.get("IncludeContainerLabel", {})
        self.exclude_labels = cfg.get("ExcludeContainerLabel", {})
        self.k8s_namespace_regex = cfg.get("K8sNamespaceRegex", "")
        self.k8s_pod_regex = cfg.get("K8sPodRegex", "")

    def match(self, info: ContainerInfo) -> bool:
        import re
        for k, v in self.include_labels.items():
            if not fnmatch.fnmatch(info.labels.get(k, ""), v):
                return False
        for k, v in self.exclude_labels.items():
            if k in info.labels and fnmatch.fnmatch(info.labels[k], v):
                return False
        if self.k8s_namespace_regex and not re.fullmatch(
                self.k8s_namespace_regex, info.k8s_namespace):
            return False
        if self.k8s_pod_regex and not re.fullmatch(
                self.k8s_pod_regex, info.k8s_pod):
            return False
        return True


class ContainerManager:
    _instance: Optional["ContainerManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self.docker = DockerDiscovery()
        self.cri = CRIDiscovery()
        self.cri_socket = CRISocketDiscovery()
        self.k8s = K8sMetadata()
        self._last: Dict[str, ContainerInfo] = {}
        self._lock = threading.Lock()
        self.on_diff = None  # callback(added, removed) -> bool (delivered)
        self._thread: Optional[threading.Thread] = None
        self._running = False

    @classmethod
    def instance(cls) -> "ContainerManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_for_testing(cls) -> None:
        """Stop the diff thread and the pod watch, join the thread and drop
        the singleton (sources are re-resolved from the environment by the
        next ``instance()``)."""
        with cls._instance_lock:
            mgr, cls._instance = cls._instance, None
        if mgr is None:
            return
        mgr.set_on_diff(None)
        mgr.k8s.stop_watch()
        for t in (mgr._thread, mgr.k8s._watch_thread):
            if t is not None:
                t.join(timeout=15)

    def discover(self) -> List[ContainerInfo]:
        """Merged view across sources; the CRI socket wins over the log-dir
        walk for the same pod/container (richer labels), docker engine for
        non-K8s containers."""
        seen: Dict[str, ContainerInfo] = {}
        for src in (self.cri_socket.list_containers(),
                    self.docker.list_containers(),
                    self.cri.list_containers()):
            for c in src:
                seen.setdefault(c.stable_key, c)
        found = list(seen.values())
        if self.k8s.available():
            for c in found:
                if c.k8s_pod:
                    meta = self.k8s.pod_metadata(c.k8s_namespace, c.k8s_pod)
                    if meta:
                        for k, v in meta.get("labels", {}).items():
                            c.labels.setdefault(f"pod.label.{k}", v)
        return found

    def diff_round(self) -> tuple:
        """One discovery diff (reference: container diff each supervision
        round, Application.cpp:386-392).  The diff baseline only advances
        when delivery succeeds, so a full queue re-emits next round rather
        than losing the add/remove events."""
        # keyed by stable_key: source-specific ids differ for the same
        # container, and a one-round source outage must not churn the diff
        found = {c.stable_key: c for c in self.discover()}
        with self._lock:
            added = [c for cid, c in found.items() if cid not in self._last]
            removed = [c for cid, c in self._last.items() if cid not in found]
        delivered = True
        if (added or removed) and self.on_diff is not None:
            try:
                delivered = self.on_diff(added, removed) is not False
            except Exception:  # noqa: BLE001
                log.exception("container diff delivery failed")
                delivered = False
        if delivered:
            with self._lock:
                self._last = found
        return added, removed

    def set_on_diff(self, callback) -> bool:
        """Install the (single) diff consumer and run discovery on an owned
        thread — discovery does blocking socket/FS I/O and must not ride the
        application supervision loop.  Returns False if already claimed."""
        with self._lock:
            if callback is not None and self.on_diff is not None:
                return False
            self.on_diff = callback
            start = callback is not None and not self._running
            if callback is None:
                self._running = False
        if start:
            self._running = True
            self._thread = threading.Thread(target=self._run,
                                            name="container-diff", daemon=True)
            self._thread.start()
        return True

    def _run(self) -> None:
        while self._running:
            try:
                self.diff_round()
            except Exception:  # noqa: BLE001
                log.exception("container diff failed")
            for _ in range(100):
                if not self._running:
                    return
                time.sleep(0.1)


K8S_META_TTL_S = 300.0
K8S_NEG_TTL_S = 30.0


class K8sMetadata:
    """Pod/service metadata cache (reference core/metadata/K8sMetadata.h:
    apiserver-backed cache with async refresh).

    * pod_metadata(): per-pod GET with a TTL'd cache;
    * start_watch(): one chunked WATCH stream over the node's pods keeps the
      cache warm — entries update on MODIFIED/DELETED without polling;
    * service_metadata(): namespace service list, TTL'd.

    Endpoint/credentials are injectable (`configure`) so tests run against
    a local fake apiserver over plain HTTP; production default is the
    in-cluster HTTPS endpoint with the mounted CA + token.
    """

    def __init__(self) -> None:
        self.token_path = "/var/run/secrets/kubernetes.io/serviceaccount/token"
        self.ca_path = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
        self._cache: Dict[str, tuple] = {}       # key → (meta, expiry)
        self._svc_cache: Dict[str, tuple] = {}   # ns → (services, expiry)
        self._lock = threading.Lock()
        self._override = None                    # (scheme, host, port, token)
        self._watch_thread: Optional[threading.Thread] = None
        self._watching = False

    def configure(self, scheme: str, host: str, port: int,
                  token: str = "") -> None:
        """Point at an explicit apiserver (tests / out-of-cluster)."""
        self._override = (scheme, host, port, token)

    def available(self) -> bool:
        if self._override is not None:
            return True
        return os.path.exists(self.token_path) and \
            bool(os.environ.get("KUBERNETES_SERVICE_HOST"))

    # -- transport ----------------------------------------------------------

    def _connect(self):
        if self._override is not None:
            scheme, host, port, token = self._override
            if scheme == "https":
                import ssl
                ctx = ssl.create_default_context()
                conn = http.client.HTTPSConnection(host, port, timeout=5,
                                                   context=ctx)
            else:
                conn = http.client.HTTPConnection(host, port, timeout=5)
            return conn, token
        import ssl
        if not os.path.exists(self.ca_path):
            log.warning("in-cluster CA bundle missing; refusing unverified "
                        "apiserver connection")
            raise OSError("no CA bundle")
        with open(self.token_path) as f:
            token = f.read().strip()
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = int(os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
        ctx = ssl.create_default_context(cafile=self.ca_path)
        return (http.client.HTTPSConnection(host, port, timeout=5,
                                            context=ctx), token)

    def _get_json(self, path: str, timeout: Optional[float] = None):
        conn, token = self._connect()
        if timeout is not None:
            conn.timeout = timeout
        conn.request("GET", path,
                     headers={"Authorization": f"Bearer {token}"}
                     if token else {})
        resp = conn.getresponse()
        data = json.loads(resp.read()) if resp.status == 200 else None
        conn.close()
        return data

    # -- pod cache ----------------------------------------------------------

    @staticmethod
    def _pod_meta(data: dict) -> dict:
        return {
            "labels": data.get("metadata", {}).get("labels", {}) or {},
            "node": data.get("spec", {}).get("nodeName", ""),
            "ip": data.get("status", {}).get("podIP", ""),
        }

    def pod_metadata(self, namespace: str, pod: str) -> Optional[dict]:
        key = f"{namespace}/{pod}"
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[1] > now:
                return hit[0]
        if not self.available():
            return None
        try:
            data = self._get_json(
                f"/api/v1/namespaces/{namespace}/pods/{pod}")
        except (OSError, ValueError, KeyError):
            data = None
        meta = self._pod_meta(data) if data is not None else None
        ttl = K8S_META_TTL_S if meta is not None else K8S_NEG_TTL_S
        with self._lock:
            if len(self._cache) > 4096:
                self._cache.clear()
            # negative results cache too (short TTL): an unauthorized or
            # unreachable apiserver must not cost a 5s timeout per pod per
            # discovery round
            self._cache[key] = (meta, now + ttl)
        return meta

    # -- watch stream -------------------------------------------------------

    def start_watch(self, node_name: str = "") -> bool:
        """Chunked WATCH over pods (optionally this node's) keeping the
        cache warm; reconnects with backoff. Returns False if unavailable."""
        if not self.available() or self._watching:
            return self._watching
        self._watching = True
        self._watch_thread = threading.Thread(
            target=self._watch_loop, args=(node_name,),
            name="k8s-meta-watch", daemon=True)
        self._watch_thread.start()
        return True

    def stop_watch(self) -> None:
        self._watching = False

    def _watch_loop(self, node_name: str) -> None:
        backoff = 1.0
        sel = (f"&fieldSelector=spec.nodeName={node_name}"
               if node_name else "")
        while self._watching:
            try:
                conn, token = self._connect()
                conn.timeout = 60
                conn.request(
                    "GET", f"/api/v1/pods?watch=1{sel}",
                    headers={"Authorization": f"Bearer {token}"}
                    if token else {})
                resp = conn.getresponse()
                if resp.status != 200:
                    conn.close()
                    raise OSError(f"watch status {resp.status}")
                backoff = 1.0
                buf = b""
                while self._watching:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if line.strip():
                            self._apply_watch_event(line)
                conn.close()
            except (OSError, ValueError, http.client.HTTPException):
                time.sleep(backoff)
                backoff = min(backoff * 2, 30.0)

    def _apply_watch_event(self, line: bytes) -> None:
        try:
            ev = json.loads(line)
        except ValueError:
            return
        obj = ev.get("object", {})
        md = obj.get("metadata", {})
        key = f"{md.get('namespace', '')}/{md.get('name', '')}"
        if key == "/":
            return
        with self._lock:
            if ev.get("type") == "DELETED":
                self._cache.pop(key, None)
            else:
                self._cache[key] = (self._pod_meta(obj),
                                    time.monotonic() + K8S_META_TTL_S)

    # -- services -----------------------------------------------------------

    def service_metadata(self, namespace: str) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            hit = self._svc_cache.get(namespace)
            if hit is not None and hit[1] > now:
                return hit[0]
        if not self.available():
            return []
        try:
            data = self._get_json(f"/api/v1/namespaces/{namespace}/services")
        except (OSError, ValueError, KeyError):
            return []
        items = (data or {}).get("items", [])
        services = [{
            "name": s.get("metadata", {}).get("name", ""),
            "selector": s.get("spec", {}).get("selector", {}) or {},
            "cluster_ip": s.get("spec", {}).get("clusterIP", ""),
        } for s in items]
        with self._lock:
            self._svc_cache[namespace] = (services, now + K8S_META_TTL_S)
        return services

    def services_for_pod(self, namespace: str, pod: str) -> List[str]:
        """Service names whose selector matches the pod's labels (the
        reference's pod→service linkage in K8sMetadata)."""
        meta = self.pod_metadata(namespace, pod)
        if meta is None:
            return []
        labels = meta.get("labels", {})
        out = []
        for svc in self.service_metadata(namespace):
            sel = svc["selector"]
            if sel and all(labels.get(k) == v for k, v in sel.items()):
                out.append(svc["name"])
        return out
