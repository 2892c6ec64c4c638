"""The send path's codecs in the port against the JAX package's: the lz4
and snappy block codecs give the same bytes (the port's ``native.py``
bindings over the repo's library), a spill payload encrypted by one
package's ``payload_crypto`` decrypts in the other's with the same key
file, ``SLSEventGroupSerializer`` gives the same LogGroup bytes for the
same groups (columnar, with parsed fields, and event groups), and the
port's ``create_compressor`` raises where the JAX package would fall
back to zlib.
"""

import os
import time

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu import native as ref_native
from loongcollector_tpu.pipeline import compression as ref_comp
from loongcollector_tpu.pipeline.serializer import sls_serializer as ref_sls
from loongcollector_tpu.utils import payload_crypto as ref_crypto
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch import native as port_native
from loongcollector_tpu_torch.pipeline import compression as port_comp
from loongcollector_tpu_torch.pipeline.serializer import \
    sls_serializer as port_sls
from loongcollector_tpu_torch.utils import payload_crypto as port_crypto
from test_torch_alarms import alarms_left_empty  # noqa: F401


def _payloads():
    rng = np.random.default_rng(3)
    out = [b"", b"a", b"hello world " * 300,
           rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
           bytes(rng.choice(list(b"abc,:\n "), 70000))]
    return out


@pytest.fixture
def libs(monkeypatch):
    """Both packages on their native library (the codecs), whatever bridge
    state this worker holds: the bridges are reset, a whole library is put
    in place through the port's locked build, and both load it within a
    deadline (the JAX package's loader may meet a file its own ``make`` in
    another process is still writing), as
    ``test_torch_parse_delimiter.py``'s ``both_native`` does."""
    monkeypatch.delenv("LOONG_DISABLE_NATIVE", raising=False)
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)
    assert port_native.ensure_built(), "the port's native build failed"
    deadline = time.monotonic() + 10.0
    while True:
        loaded = {name: mod.get_lib() for name, mod in
                  (("loongcollector_tpu", ref_native),
                   ("loongcollector_tpu_torch", port_native))}
        missing = sorted(name for name, lib in loaded.items()
                         if lib is None
                         or not hasattr(lib, "lct_snappy_compress"))
        if not missing or time.monotonic() > deadline:
            break
        for mod in (ref_native, port_native):
            mod._lib, mod._load_attempted = None, False
        time.sleep(0.2)
    assert not missing, f"native bridge not loaded: {missing}"
    yield
    for mod in (ref_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_attempted", False)


@pytest.mark.parametrize("i", range(5))
def test_lz4_and_snappy_bytes_equal(libs, i):
    data = _payloads()[i]
    lz = port_native.lz4_compress(data)
    assert lz == ref_native.lz4_compress(data)
    assert port_native.lz4_decompress(lz, len(data)) == data
    sn = port_native.snappy_compress(data)
    assert sn == ref_native.snappy_compress(data)
    assert port_native.snappy_decompress(sn) == data
    assert ref_native.snappy_decompress(sn) == data


@pytest.mark.parametrize("kind", ["lz4", "snappy", "zlib", "zstd", "none"])
def test_compressors_agree(libs, kind):
    data = _payloads()[4]
    try:
        ref = ref_comp.create_compressor(kind)
    except RuntimeError:
        pytest.fail(f"the reference has no {kind} codec here")
    port = port_comp.create_compressor(kind)
    assert port.name == ref.name
    if kind != "zstd" or ref_comp._zstd is not None:
        assert port.compress(data) == ref.compress(data)
    assert port.decompress(port.compress(data), len(data)) == data


def test_codec_missing_raises(libs, monkeypatch):
    """Where the JAX package falls back to zlib, the port raises."""
    monkeypatch.setattr(port_comp, "_native_codecs_available", lambda: False)
    for kind in ("lz4", "snappy"):
        with pytest.raises(RuntimeError):
            port_comp.create_compressor(kind)
    monkeypatch.setattr(port_comp, "_zstd", None)
    with pytest.raises(RuntimeError):
        port_comp.create_compressor("zstd")
    with pytest.raises(ValueError):
        port_comp.create_compressor("brotli")
    monkeypatch.setattr(ref_comp, "_native_codecs_available", lambda: False)
    assert ref_comp.create_compressor("lz4").name == "zlib"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_payload_crypto_crosses(tmp_path, writer):
    key = str(tmp_path / "spill_key")
    mods = {"reference": ref_crypto, "port": port_crypto}
    enc = mods[writer].PayloadCipher(key)
    dec = mods["port" if writer == "reference" else "reference"] \
        .PayloadCipher(key)
    assert oct(os.stat(key).st_mode & 0o777) == "0o600"
    for data in _payloads():
        blob = enc.encrypt(data)
        assert dec.decrypt(blob) == data
        assert enc.decrypt(blob) == data
    blob = bytearray(enc.encrypt(b"secret"))
    blob[-1] ^= 1
    assert dec.decrypt(bytes(blob)) is None
    other = mods[writer].PayloadCipher(str(tmp_path / "other_key"))
    assert other.decrypt(enc.encrypt(b"x")) is None
    (tmp_path / "bad_key").write_bytes(b"short")
    with pytest.raises(ValueError):
        port_crypto.PayloadCipher(str(tmp_path / "bad_key"))


def _sls_groups(models, seed):
    rng = np.random.default_rng(seed)
    groups = []
    # event groups
    g = models.PipelineEventGroup()
    sb = g.source_buffer
    g.set_tag(b"__path__", b"/var/log/a.log")
    for i in range(5):
        ev = g.add_log_event(1700000000 + i)
        ev.set_content(sb.copy_string(b"k%d" % i), sb.copy_string(
            b"v" * int(rng.integers(0, 40))))
        ev.set_content(sb.copy_string(b"msg"), sb.copy_string(b"hello"))
    groups.append(g)
    # columnar groups: raw content, and parsed fields with absent spans
    for with_fields in (False, True):
        lines = [b"line %d " % i + b"x" * int(rng.integers(0, 50))
                 for i in range(40)]
        g = models.PipelineEventGroup()
        sb = g.source_buffer
        offs, lens = [], []
        for ln in lines:
            v = sb.copy_string(ln)
            offs.append(v.offset)
            lens.append(len(ln))
        offs = np.array(offs, np.int32)
        lens = np.array(lens, np.int32)
        cols = models.ColumnarLogs(offs, lens,
                                   np.arange(40, dtype=np.int64) + 17)
        if with_fields:
            cols.set_field("a", offs, np.minimum(lens, 4))
            cols.set_field("b", offs + 5,
                           np.where(np.arange(40) % 3 == 0, -1, 2)
                           .astype(np.int32))
            cols.content_consumed = True
        g.set_columns(cols)
        g.set_tag(b"host", b"h%d" % seed)
        groups.append(g)
    return groups


@pytest.mark.parametrize("seed", [0, 1])
def test_sls_serializer_same_bytes(libs, seed):
    ref = ref_sls.SLSEventGroupSerializer(topic=b"t", source=b"s")
    port = port_sls.SLSEventGroupSerializer(topic=b"t", source=b"s")
    rg = _sls_groups(ref_models, seed)
    pg = _sls_groups(port_models, seed)
    for i in range(len(rg)):
        assert port.serialize([pg[i]]) == ref.serialize([rg[i]]), i
    want = ref.serialize(rg)
    assert port.serialize(pg) == want
    assert bytes(port.serialize_view(pg)) == want
    back = port_sls.parse_loggroup(want)
    assert len(back) == sum(len(g) for g in pg)
    assert back.get_tag(b"__topic__").to_bytes() == b"t"
