"""The port's eBPF driver ABI: ``CEvent`` and ``CDriver`` against the JAX
package's mirrors and against ``native/ebpf_driver_abi.h``, and the
simulation driver (``native/libloong_ebpf_sim.so``) through the port's
``SoAdapter``.

The header's struct is laid out here by the C rules (each field at the
next multiple of its alignment, the size rounded up to the largest), from
the header's own field list and ``#define`` constants.  The driver keeps
process-wide state (one handle per path, its sources and poll thread), so
every test that starts a source stops it in a ``finally``: a source left
running would reach the next test in the same worker.
"""

import ctypes
import os
import re
import time

import pytest

from loongcollector_tpu.input.ebpf import adapter as ref_adapter
from loongcollector_tpu_torch.input.ebpf import adapter
from loongcollector_tpu_torch.input.ebpf.adapter import (
    ABI_VERSION, AbiMismatch, CDriver, CEvent, EventSource, RawKernelEvent,
    SoAdapter, default_driver_path)
from test_torch_alarms import alarms_left_empty  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "native", "ebpf_driver_abi.h")

_C_TYPES = {"uint64_t": 8, "uint32_t": 4, "int32_t": 4, "uint16_t": 2,
            "uint8_t": 1, "char": 1}


def _header_layout():
    """{field: (offset, size)} and the struct size of
    ``loong_ebpf_event_t``, from the header."""
    text = open(HEADER).read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define\s+(\w+)\s+\(?(\d+)[uU]?\)?", text)}
    body = re.search(r"typedef struct loong_ebpf_event \{(.*?)\}", text,
                     re.S).group(1)
    layout, off, align_max = {}, 0, 1
    for m in re.finditer(r"^\s*(\w+)\s+(\w+)((?:\[\w+\])*);", body, re.M):
        ctype, name, dims = m.groups()
        size = align = _C_TYPES[ctype]
        for d in re.findall(r"\[(\w+)\]", dims):
            size *= consts[d] if d in consts else int(d)
        off = -(-off // align) * align
        layout[name] = (off, size)
        off += size
        align_max = max(align_max, align)
    return layout, -(-off // align_max) * align_max


def test_event_layout_equals_header_and_reference():
    layout, size = _header_layout()
    assert len(layout) == len(CEvent._fields_) == 17
    for name, _ctype in CEvent._fields_:
        field = getattr(CEvent, name)
        assert (field.offset, field.size) == layout[name], name
        ref_field = getattr(ref_adapter.CEvent, name)
        assert (field.offset, field.size) == (ref_field.offset,
                                              ref_field.size), name
    assert ctypes.sizeof(CEvent) == size == ctypes.sizeof(
        ref_adapter.CEvent) == 7504


def test_driver_vtable_equals_reference():
    assert [n for n, _ in CDriver._fields_] == [
        n for n, _ in ref_adapter.CDriver._fields_]
    for name, _ in CDriver._fields_:
        assert getattr(CDriver, name).offset == getattr(
            ref_adapter.CDriver, name).offset
    assert ctypes.sizeof(CDriver) == 8 + 5 * ctypes.sizeof(ctypes.c_void_p)
    assert ABI_VERSION == ref_adapter.ABI_VERSION
    assert re.search(rf"#define\s+LOONG_EBPF_ABI_VERSION\s+{ABI_VERSION}u?\b",
                     open(HEADER).read())


def test_event_conversion_equals_reference():
    """``_event_to_c`` gives the reference's bytes, and ``_event_from_c``
    of them the reference's event."""
    ev = dict(pid=4242, timestamp_ns=123456789, fd=7, ppid=3, ktime=99,
              local_addr="10.0.0.1:80", remote_addr="10.0.0.2:555",
              direction="egress", payload=b"\x00\x01binary\xff" * 700,
              call_name="security_file_permission" + "x" * 20,
              path="/etc/passwd", flags=0o644,
              stack=[f"frame_{i}" for i in range(40)])
    port = adapter._event_to_c(RawKernelEvent(
        source=EventSource.FILE_SECURITY, **ev))
    ref = ref_adapter._event_to_c(ref_adapter.RawKernelEvent(
        source=ref_adapter.EventSource.FILE_SECURITY, **ev))
    assert bytes(port) == bytes(ref)
    back = adapter._event_from_c(port)
    ref_back = ref_adapter._event_from_c(ref)
    assert back.source.value == ref_back.source.value == "file_security"
    fields = [f for f in vars(back) if f != "source"]
    assert {f: getattr(back, f) for f in fields} == {
        f: getattr(ref_back, f) for f in fields}


needs_driver = pytest.mark.skipif(
    not os.path.exists(default_driver_path()),
    reason="the simulation driver is not built (make -C native "
           "libloong_ebpf_sim.so)")


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


@needs_driver
def test_handshake():
    ad = SoAdapter(default_driver_path())
    assert ad._drv.abi_version == ABI_VERSION
    assert ad._drv.event_size == ctypes.sizeof(CEvent)
    assert ad.path == default_driver_path() \
        == ref_adapter.default_driver_path()


@needs_driver
def test_handshake_refuses_a_wrong_size(monkeypatch):
    """A driver whose event size differs is refused at load."""

    class Bigger(ctypes.Structure):
        _fields_ = [("e", CEvent), ("extra", ctypes.c_uint64)]
    monkeypatch.setattr(adapter, "CEvent", Bigger)
    with pytest.raises(AbiMismatch, match="event struct"):
        SoAdapter(default_driver_path())


@needs_driver
def test_round_trip_through_abi():
    ad = SoAdapter(default_driver_path())
    got = []
    assert ad.start_plugin(EventSource.FILE_SECURITY, got.append)
    try:
        ev = RawKernelEvent(
            source=EventSource.FILE_SECURITY, pid=4242,
            timestamp_ns=123456789, fd=7, ppid=2, ktime=77,
            local_addr="10.0.0.1:80", remote_addr="10.0.0.2:555",
            direction="ingress", payload=b"\x00\x01binary\xff",
            call_name="security_file_permission", path="/etc/passwd",
            flags=0o644, stack=["frame_a", "frame_b"])
        assert ad.feed(ev)
        assert _wait(lambda: got), "event never delivered through the driver"
        assert vars(got[0]) == vars(ev)
        assert ad.delivered == 1 and ad.callback_errors == 0
    finally:
        ad.stop_plugin(EventSource.FILE_SECURITY)


@needs_driver
def test_callback_errors_are_counted_not_raised():
    ad = SoAdapter(default_driver_path())
    seen = []

    def handler(ev):
        seen.append(ev.pid)
        if ev.pid % 2:
            raise ValueError("odd pid")
    assert ad.start_plugin(EventSource.CPU_PROFILING, handler)
    try:
        for pid in range(6):
            assert ad.feed(RawKernelEvent(source=EventSource.CPU_PROFILING,
                                          pid=pid))
        assert _wait(lambda: len(seen) == 6)
        assert _wait(lambda: ad.delivered + ad.callback_errors == 6)
        assert (ad.delivered, ad.callback_errors) == (3, 3)
    finally:
        ad.stop_plugin(EventSource.CPU_PROFILING)


@needs_driver
def test_double_start_rebinds_and_stop_without_start_fails():
    ad = SoAdapter(default_driver_path())
    first, second = [], []
    assert ad.start_plugin(EventSource.NETWORK_SECURITY, first.append)
    try:
        assert ad.start_plugin(EventSource.NETWORK_SECURITY, second.append)
        ad.feed(RawKernelEvent(source=EventSource.NETWORK_SECURITY, pid=9))
        assert _wait(lambda: second) and second[0].pid == 9
        assert not first
        assert len(ad._retired_cbs) == 1
    finally:
        assert ad.stop_plugin(EventSource.NETWORK_SECURITY)
    assert not ad.stop_plugin(EventSource.NETWORK_SECURITY)
    assert len(ad._retired_cbs) == 2


@needs_driver
def test_suspend_drops_and_oversize_truncates():
    ad = SoAdapter(default_driver_path())
    got = []
    assert ad.start_plugin(EventSource.NETWORK_OBSERVE, got.append)
    try:
        assert ad.suspend_plugin(EventSource.NETWORK_OBSERVE)
        ad.feed(RawKernelEvent(source=EventSource.NETWORK_OBSERVE, pid=1))
        time.sleep(0.1)
        assert not got
        assert ad.resume_plugin(EventSource.NETWORK_OBSERVE)
        ad.feed(RawKernelEvent(source=EventSource.NETWORK_OBSERVE, pid=2,
                               payload=b"x" * 10000))
        assert _wait(lambda: got)
        assert got[0].pid == 2 and len(got[0].payload) == 4096
    finally:
        ad.stop_plugin(EventSource.NETWORK_OBSERVE)


def test_get_adapter_and_set_adapter(monkeypatch):
    """``get_adapter`` prefers the driver library and falls back to the
    mock without one, as the reference's; ``set_adapter`` replaces it."""
    monkeypatch.setattr(adapter, "_default_adapter", None)
    monkeypatch.setenv("LOONG_EBPF_DRIVER", "/nonexistent/driver.so")
    assert isinstance(adapter.get_adapter(), adapter.MockAdapter)
    mock = adapter.MockAdapter()
    adapter.set_adapter(mock)
    assert adapter.get_adapter() is mock
    monkeypatch.delenv("LOONG_EBPF_DRIVER")
    monkeypatch.setattr(adapter, "_default_adapter", None)
    if os.path.exists(default_driver_path()):
        assert isinstance(adapter.get_adapter(), SoAdapter)
