"""The trace reduction on a hand-made trace: busy time, the device ops and
idle gaps of the breakdown, and device time charged to a span by launch."""

import pytest

from benchmark import trace as T


def hand_trace():
    tr = T.Trace()
    tr.window = (0, 50)
    tr.device = [("k1", 10, 20, (1, 0)), ("k2", 30, 40, (2, 0)), ("k1", 45, 60, (3, 0))]
    tr.host = [("bench.window", 0, 50), ("eval.rerank", 5, 44),
               ("cudaStreamSynchronize", 20, 30)]
    tr.launch_ns = {1: 6, 2: 25, 3: 7}
    tr.spans = {"evlm.fused_attention": [(5, 8)]}
    return tr


def test_busy_ops_and_gaps():
    s = T.summary(hand_trace())
    assert s["busy_s"] == pytest.approx(25e-9) and s["window_s"] == pytest.approx(50e-9)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops == {"k1": pytest.approx(15e-9), "k2": pytest.approx(10e-9)}
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0,10): 5 under the window, 5 under the rerank; [20,30): the sync;
    # [40,45): 4 under the rerank, 1 under the window
    assert gaps == {T.HOST_PYTHON: pytest.approx(6e-9), "eval.rerank": pytest.approx(9e-9),
                    "cudaStreamSynchronize": pytest.approx(10e-9)}


def test_device_time_under_a_span():
    tr = hand_trace()
    assert T.device_seconds_under(tr, "evlm.fused_attention") == pytest.approx(15e-9)
    assert T.device_seconds_under(tr, "no.such.span") is None
    tr.launch_ns = {}
    assert T.device_seconds_under(tr, "evlm.fused_attention") is None


def test_host_timeline_is_innermost():
    pieces = T.host_timeline([("a", 0, 10), ("b", 2, 8), ("c", 4, 6)])
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 8, "b"), (8, 10, "a")]


def test_device_window_between_markers():
    """The slice traced with the device's activity alone: the window runs
    from the first marker's end to the last's start, busy is the union of
    the events between them."""
    events = [("k2", 30, 40), ("mark", 0, 10), ("k1", 12, 20), ("k3", 35, 45), ("mark", 60, 62)]
    got = T.device_window_of(events)
    assert got["window_s"] == pytest.approx(50e-9) and got["busy_s"] == pytest.approx(23e-9)
    assert got["markers"] == ["mark", "mark"] and got["events"] == 3
    assert T.device_window_of([("mark", 0, 1)]) is None
