"""The window's arithmetic: rates over the whole window, tails over every
item, the device's idle share from overlapping intervals."""
from rtbench.harness import window


def frames(durations):
    starts, ends, t = [], [], 0.0
    for d in durations:
        starts.append(t)
        t += d
        ends.append(t)
    return starts, ends


def test_rate_is_the_whole_window_over_its_items():
    starts, ends = frames([0.04] * 100)
    assert abs(window.per_item_ms(starts, ends) - 40.0) < 1e-9


def test_a_stall_moves_the_rate_and_the_p95():
    base = [0.04] * 300
    stalled = list(base)
    for k in range(0, 300, 15):  # every 15th frame stalls: 20 of 300
        stalled[k] = 0.5
    s0, e0 = frames(base)
    s1, e1 = frames(stalled)
    assert window.per_item_ms(s1, e1) > window.per_item_ms(s0, e0) * 1.5
    p0 = window.percentile([e - s for s, e in zip(s0, e0)], 95)
    p1 = window.percentile([e - s for s, e in zip(s1, e1)], 95)
    assert abs(p0 - 0.04) < 1e-12 and p1 == 0.5


def test_one_stall_moves_the_rate_but_not_a_median_of_chunks():
    durations = [0.04] * 100
    durations[50] = 2.0
    starts, ends = frames(durations)
    assert window.per_item_ms(starts, ends) > 55.0


def test_percentile_matches_linear_interpolation():
    assert window.percentile([1, 2, 3, 4], 50) == 2.5
    assert window.percentile([5], 95) == 5
    assert window.percentile([], 95) is None


def test_idle_share_counts_overlapping_device_intervals_once():
    from rtbench.harness.trace import Trace

    device = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 12.0)]
    tr = Trace(device=[(s, e, "k") for s, e in device], notes=[],
               lo=0.0, hi=10.0)
    assert tr.busy_s() == 4.5
    assert abs(tr.idle_pct() - 55.0) < 1e-12
    assert tr.device_seconds(lambda n: n == "k") == 4.0 + 1.0 + 0.5
    assert window.gaps(device, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                              (7.0, 9.5)]


def test_trace_names_idle_gaps_by_the_innermost_open_span():
    from rtbench.harness.trace import Trace

    tr = Trace(device=[(1.0, 2.0, "void whitted_kernel<4>(float*)"),
                       (5.0, 6.0, "Memcpy DtoH")],
               notes=[(0.0, 10.0, "frame"), (2.0, 4.0, "render")],
               lo=0.0, hi=10.0)
    gaps = dict(tr.idle_gaps())
    assert gaps == {"frame": 1.0 + 4.0, "render": 3.0}
    assert tr.busy_s() == 2.0
    assert tr.top_ops()[0] == ["void whitted_kernel<4>", 1.0]
