"""The port's Batcher, flush strategy, limiters and sender queues held
against the JAX package's (``pipeline/batch/``, ``pipeline/queue/
limiter.py``, ``pipeline/queue/sender_queue.py``; the sender-queue cases
of ``tests/test_queues.py``): the same adds under one injected clock give
the same flushed batches, the same scripted limiter calls the same
decisions, and the same pushes and pops the same available items,
watermark states, feedback calls and retire refusals.
"""

import types

import numpy as np
import pytest

from loongcollector_tpu import models as ref_models
from loongcollector_tpu.pipeline.batch import batcher as ref_batcher
from loongcollector_tpu.pipeline.batch import flush_strategy as ref_fs
from loongcollector_tpu.pipeline.queue import limiter as ref_limiter
from loongcollector_tpu.pipeline.queue import sender_queue as ref_sq
from loongcollector_tpu_torch import models as port_models
from loongcollector_tpu_torch.pipeline.batch import batcher as port_batcher
from loongcollector_tpu_torch.pipeline.batch import flush_strategy as port_fs
from loongcollector_tpu_torch.pipeline.batch.timeout_flush_manager import \
    TimeoutFlushManager
from loongcollector_tpu_torch.pipeline.queue import limiter as port_limiter
from loongcollector_tpu_torch.pipeline.queue import sender_queue as port_sq
from test_torch_alarms import alarms_left_empty  # noqa: F401

SIDES = {"reference": (ref_models, ref_batcher, ref_fs, ref_limiter, ref_sq),
         "port": (port_models, port_batcher, port_fs, port_limiter,
                  port_sq)}


class _Clock:
    """An injected ``time`` module: ``monotonic()`` reads ``now``."""

    def __init__(self):
        self.now = 1000.0

    def module(self):
        return types.SimpleNamespace(monotonic=lambda: self.now)


def _group(models, tag, contents):
    g = models.PipelineEventGroup()
    sb = g.source_buffer
    g.set_tag(b"topic", tag)
    for c in contents:
        ev = g.add_log_event(1)
        ev.set_content(sb.copy_string(b"content"), sb.copy_string(c))
    return g


def _script(seed):
    """(op, tag, contents, dt) steps, seeded."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(160):
        r = rng.random()
        if r < 0.08:
            steps.append(("timeout", None, None, float(rng.uniform(0, 1.5))))
        else:
            n = int(rng.integers(1, 5))
            contents = [b"x" * int(rng.integers(1, 90)) + b"%d" % i
                        for _ in range(n)]
            steps.append(("add", [b"a", b"b", b"c"][int(rng.integers(3))],
                          contents, float(rng.uniform(0, 0.4))))
    return steps


def _batches(side, seed, monkeypatch):
    models, batcher, fs, _, _ = SIDES[side]
    clock = _Clock()
    monkeypatch.setattr(batcher, "time", clock.module())
    monkeypatch.setattr(fs, "time", clock.module())
    out = []
    b = batcher.Batcher(
        fs.FlushStrategy(min_cnt=7, min_size_bytes=300, max_size_bytes=900,
                         timeout_secs=1.0),
        on_flush=lambda groups: out.append(
            [(g.get_tag(b"topic").to_bytes(),
              [ev.get_content(b"content").to_bytes() for ev in g.events])
             for g in groups]))
    try:
        for op, tag, contents, dt in _script(seed):
            clock.now += dt
            if op == "timeout":
                b.flush_timeout()
                out.append("tick")
            else:
                b.add(_group(models, tag, contents))
                out.append(b.pending_events())
        b.flush_all()
        out.append(b.pending_events())
    finally:
        b.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batcher_same_batches_under_one_clock(seed, monkeypatch):
    ref = _batches("reference", seed, monkeypatch)
    port = _batches("port", seed, monkeypatch)
    assert port == ref
    assert sum(isinstance(x, list) for x in port) > 10


def test_batcher_registers_with_the_ports_timeout_manager():
    b = port_batcher.Batcher(port_fs.FlushStrategy())
    try:
        assert b in TimeoutFlushManager.instance()._batchers
    finally:
        b.close()
    assert b not in TimeoutFlushManager.instance()._batchers


def _limiter_trace(side, monkeypatch):
    _, _, _, limiter, _ = SIDES[side]
    clock = _Clock()
    monkeypatch.setattr(limiter, "time", clock.module())
    rng = np.random.default_rng(7)
    cl = limiter.ConcurrencyLimiter("ep", max_concurrency=12,
                                    min_concurrency=2)
    rl = limiter.RateLimiter(max_bytes_per_sec=1000)
    trace = []
    for _ in range(400):
        op = int(rng.integers(7))
        clock.now += float(rng.uniform(0, 0.3))
        if op == 0:
            cl.post_pop()
        elif op == 1:
            cl.on_done()
        elif op == 2:
            cl.on_success()
        elif op == 3:
            cl.on_fail(slow=bool(rng.integers(2)))
        elif op == 4:
            rl.post_pop(int(rng.integers(1, 400)))
        trace.append((cl.is_valid_to_pop(), cl.current_limit, cl.in_flight,
                      rl.is_valid_to_pop()))
    return trace


def test_limiters_make_the_same_decisions(monkeypatch):
    assert _limiter_trace("port", monkeypatch) == \
        _limiter_trace("reference", monkeypatch)


@pytest.mark.parametrize("side", ["reference", "port"])
def test_queues_aimd_and_gates(side):
    """tests/test_queues.py TestLimiters, through both packages."""
    _, _, _, limiter, _ = SIDES[side]
    cl = limiter.ConcurrencyLimiter("ep", max_concurrency=10)
    cl.on_fail()
    cl.on_fail(slow=True)
    cl.on_success()
    assert cl.current_limit == 5
    cl = limiter.ConcurrencyLimiter("ep", max_concurrency=1)
    cl.post_pop()
    assert not cl.is_valid_to_pop()
    cl.on_done()
    assert cl.is_valid_to_pop()
    rl = limiter.RateLimiter(max_bytes_per_sec=100)
    rl.post_pop(150)
    assert not rl.is_valid_to_pop()


class _Fb:
    def __init__(self):
        self.calls = []

    def feedback(self, key):
        self.calls.append(key)


def _queue_trace(side):
    _, _, _, limiter, sq = SIDES[side]
    trace = []
    q = sq.SenderQueue(key=1, capacity=3)
    fb = _Fb()
    q.set_feedback(fb)
    cl = limiter.ConcurrencyLimiter("ep", max_concurrency=2)
    q.concurrency_limiters = [cl]
    items = [sq.SenderQueueItem(b"p%d" % i, 2, queue_key=1, event_cnt=i,
                                spans=((1, 2, i, 1),)) for i in range(5)]
    for it in items:
        trace.append(("push", q.push(it), q.is_valid_to_push(), q.size()))
    got = q.get_available_items(10)
    trace.append(("avail", [i.data for i in got],
                  [i.try_count for i in got]))
    cl.on_done()
    q.reset_item_status(got[0])
    trace.append(("avail", [i.data for i in q.get_available_items(10)]))
    for it in got:
        trace.append(("remove", q.remove(it), q.is_valid_to_push(),
                      list(fb.calls)))
    for _ in range(2):
        cl.on_done()
    trace.append(("avail", [i.data for i in q.get_available_items(1)]))
    m = sq.SenderQueueManager()
    mq = m.create_or_reuse_queue(7, pipeline_name="p")
    trace.append(("mpush", mq.push(sq.SenderQueueItem(b"m", 1, queue_key=7)),
                  m.wait_for_data(0.0), m.all_empty()))
    trace.append(("mavail", [i.data for i in m.get_available_items()]))
    m.delete_queue(7)
    trace.append(("retired", mq.push(sq.SenderQueueItem(b"n", 1)),
                  mq.get_available_items(10), m.get_queue(7)))
    return trace


def test_sender_queue_same_items_and_retire():
    assert _queue_trace("port") == _queue_trace("reference")


@pytest.mark.parametrize("side", ["reference", "port"])
def test_available_items_respect_limiters(side):
    """tests/test_queues.py TestSenderQueue, through both packages."""
    _, _, _, limiter, sq = SIDES[side]
    q = sq.SenderQueue(key=1)
    cl = limiter.ConcurrencyLimiter("ep", max_concurrency=1)
    q.concurrency_limiters = [cl]
    q.push(sq.SenderQueueItem(b"a", 1, queue_key=1))
    q.push(sq.SenderQueueItem(b"b", 1, queue_key=1))
    items = q.get_available_items(10)
    assert len(items) == 1
    cl.on_done()
    q.remove(items[0])
    assert len(q.get_available_items(10)) == 1
