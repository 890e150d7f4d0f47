"""The program's span log read against a hand-made device trace
(benchmark/spans.py), and device time charged to two same-named nested
ranges (the program's evlm.fused_attention inside a wrapper's) once."""

import pytest

from benchmark import spans as S
from benchmark import trace as T

# (name, parent, t0_ns, t1_ns), as profiler.recording logs them; the last
# span was still open when its recording ended
LOG = [("top", None, 0, 100), ("a", 0, 10, 40), ("b", 1, 20, 30), ("a", 0, 60, 80),
       ("open", None, 110, None)]
DEVICE = [(5, 15), (25, 28), (50, 65), (85, 105)]
WINDOW = (0, 120)


def test_innermost_pieces():
    assert S.innermost(LOG, WINDOW) == [(0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1),
                                        (40, 60, 0), (60, 80, 3), (80, 100, 0),
                                        (110, 120, 4)]


def test_idle_under_each_innermost_span():
    """Idle [0,5) [15,25) [28,50) [65,85) [105,120): top 5 + 10 + 5, the
    first a 5 + 10, b 5 + 2, the second a 15, the open span 10, [105,110)
    under no span."""
    per, outside = S.idle_under(DEVICE, LOG, WINDOW)
    assert per == pytest.approx([20e-9, 15e-9, 7e-9, 15e-9, 10e-9])
    assert outside == pytest.approx(5e-9)
    inside = S.subtree(LOG, {"a"})
    assert inside == [False, True, True, True, False]
    assert sum(p for p, i in zip(per, inside) if i) == pytest.approx(37e-9)


def test_idle_under_a_window_cut_short():
    per, outside = S.idle_under(DEVICE, LOG, (20, 70))
    assert per == pytest.approx([10e-9, 10e-9, 7e-9, 5e-9, 0.0])
    assert outside == 0.0


def test_seconds_of_a_name_over_its_ranges():
    assert S.seconds_under(LOG, "a") == pytest.approx(50e-9)
    assert S.seconds_under(LOG, "a", (30, 70)) == pytest.approx(20e-9)
    assert S.seconds_under(LOG, "open") == 0.0


def test_device_time_under_two_nested_ranges_of_one_name():
    """The wrapper's evlm.fused_attention (5-40) around the program's own
    (6-39): the two events launched inside count once each, the one
    launched after neither."""
    tr = T.Trace()
    tr.window = (0, 100)
    tr.device = [("k1", 10, 20, (1, 0)), ("k2", 30, 35, (2, 0)), ("k3", 60, 70, (3, 0))]
    tr.launch_ns = {1: 10, 2: 20, 3: 50}
    tr.spans = {"evlm.fused_attention": [(5, 40), (6, 39)]}
    assert T.device_seconds_under(tr, "evlm.fused_attention") == pytest.approx(15e-9)
