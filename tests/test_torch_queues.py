"""The port's bounded process queues and queue manager held against the
JAX package's (``tests/test_queues.py:30-80``): the same pushes and pops
through both give the same watermark states, feedback calls, rejections,
byte accounting and round-robin pop order.
"""

import pytest

from loongcollector_tpu.models import PipelineEventGroup as RefGroup
from loongcollector_tpu.pipeline.queue import bounded_queue as ref_bq
from loongcollector_tpu.pipeline.queue import process_queue_manager as ref_pqm
from loongcollector_tpu_torch.models import PipelineEventGroup as PortGroup
from loongcollector_tpu_torch.models import SourceBuffer as PortBuffer
from loongcollector_tpu_torch.pipeline.queue import bounded_queue as port_bq
from loongcollector_tpu_torch.pipeline.queue import \
    process_queue_manager as port_pqm

SIDES = {"reference": (ref_bq, ref_pqm, RefGroup),
         "port": (port_bq, port_pqm, PortGroup)}


def _group(cls, nbytes: int = 0):
    if cls is PortGroup and nbytes:
        sb = PortBuffer(capacity=nbytes + 16)
        g = cls(sb)
        g.add_raw_event(1).set_content(sb.copy_string(b"x" * nbytes))
        return g
    g = cls()
    if nbytes:
        sb = g.source_buffer
        g.add_raw_event(1).set_content(sb.copy_string(b"x" * nbytes))
    else:
        g.add_log_event(1)
    return g


def _feedback(bq):
    class _Fb(bq.FeedbackInterface):
        def __init__(self):
            self.calls = []

        def feedback(self, key):
            self.calls.append(key)
    return _Fb()


def _watermarks(side):
    bq, _pqm, cls = SIDES[side]
    q = bq.BoundedProcessQueue(key=1, capacity=3)
    fb = _feedback(bq)
    q.set_feedback(fb)
    seen = []
    for _ in range(4):
        seen.append((q.push(_group(cls)), q.is_valid_to_push()))
    for _ in range(3):
        seen.append((q.pop() is not None, q.is_valid_to_push(),
                     list(fb.calls)))
    q.set_pop_enabled(False)
    seen.append((q.push(_group(cls)), q.pop()))
    q.set_pop_enabled(True)
    seen.append((q.pop() is not None, q.size(), q.empty(),
                 q.total_pushed, q.total_popped, q.total_rejected))
    return seen


def _byte_bound(side):
    bq, _pqm, cls = SIDES[side]
    q = bq.BoundedProcessQueue(key=7, capacity=100, max_bytes=3000)
    fb = _feedback(bq)
    q.set_feedback(fb)
    seen = []
    for _ in range(4):
        seen.append((q.push(_group(cls, 1000)), q.is_valid_to_push(),
                     q.bytes_queued() > 0))
    run = q.pop_run(max_groups=8, max_bytes=1500)
    seen.append((len(run), q.is_valid_to_push(), fb.calls))
    run = q.pop_run(max_groups=8, max_bytes=1 << 20)
    seen.append((len(run), q.is_valid_to_push(), fb.calls, q.bytes_queued()))
    return seen


def _priorities(side):
    _bq, pqm, cls = SIDES[side]
    m = pqm.ProcessQueueManager()
    m.create_or_reuse_queue(1, priority=2)
    m.create_or_reuse_queue(2, priority=0)
    m.push_queue(1, _group(cls))
    m.push_queue(2, _group(cls))
    first = m.pop_item(timeout=0)[0]
    m2 = pqm.ProcessQueueManager()
    for k in (1, 2, 3):
        m2.create_or_reuse_queue(k, priority=1)
        for _ in range(k):
            m2.push_queue(k, _group(cls))
    order = [m2.pop_item(timeout=0)[0] for _ in range(6)]
    empty = (m2.pop_item(timeout=0), m2.all_empty())
    m3 = pqm.ProcessQueueManager()
    for k in (1, 2):
        m3.create_or_reuse_queue(k, priority=1)
        for _ in range(5):
            m3.push_queue(k, _group(cls))
    runs = [(key, len(g)) for key, g in
            iter(lambda: m3.pop_run(timeout=0, max_groups=3), None)]
    m3.delete_queue(1)
    gone = (m3.push_queue(1, _group(cls)), m3.get_queue(1))
    return first, order, empty, runs, gone


@pytest.mark.parametrize("script", [_watermarks, _byte_bound, _priorities],
                         ids=["watermark_state_machine", "byte_watermark",
                              "priority_round_robin"])
def test_queue_scenario_matches_reference(script):
    ref = script("reference")
    port = script("port")
    assert port == ref


def test_watermark_values():
    seen = _watermarks("port")
    assert seen[:4] == [(True, True), (True, True), (True, False),
                        (False, False)]
    # popping to the low watermark (3 * 2/3) re-opens the queue once
    assert seen[4] == (True, True, [1])
    first, order, empty, runs, gone = _priorities("port")
    assert first == 2 and sorted(order) == [1, 2, 2, 3, 3, 3]
    assert empty == (None, True) and gone == (False, None)
    assert runs == [(1, 3), (2, 3), (1, 2), (2, 2)]
