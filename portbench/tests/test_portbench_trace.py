"""The reduction of a profiled stretch: busy intervals merged before they
are summed, clipped to the stretch, idle gaps named by the host."""

import pytest

from portbench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([(0, 10), (20, 30)], 0, 40, 20),
    ([(0, 10), (5, 15)], 0, 40, 15),            # overlap counted once
    ([(0, 10), (2, 4), (10, 12)], 0, 40, 12),   # nested and touching
    ([(-5, 5), (35, 50)], 0, 40, 10),           # clipped to the stretch
    ([(50, 60)], 0, 40, 0),
    ([], 0, 40, 0),
])
def test_union_of_busy_intervals(intervals, lo, hi, want):
    merged = trace.union(intervals, lo, hi)
    assert sum(e - s for s, e in merged) == want
    idle = sum(e - s for s, e in trace.gaps(merged, lo, hi))
    assert idle == (hi - lo) - want


def test_reduce_reads_the_stretch_wall_busy_share_and_gaps():
    events = [
        ev("user_annotation", trace.MARK, 100, 1000),
        ev("kernel", "void fused_fwd(float const*)", 100, 200),
        ev("kernel", "sm90_xmma_conv", 250, 250),     # overlaps the first
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 700, 100),
        ev("kernel", "outside", 2000, 100),
        ev("cpu_op", "aten::copy_", 520, 100),
        ev("cuda_runtime", "cudaGraphLaunch", 820, 10),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(500e-6)      # 100-500, 700-800
    assert r["launches_by_name"] == {"void fused_fwd(float const*)": 1,
                                     "sm90_xmma_conv": 1,
                                     "Memcpy HtoD (Pageable -> Device)": 1}
    gaps = dict((n, s) for n, s in r["idle_gaps"])
    assert gaps["no traced host op"] == pytest.approx(300e-6)   # 800-1100
    assert gaps["aten::copy_"] == pytest.approx(200e-6)         # 500-700
    assert r["device_ops"][0][0] == "sm90_xmma_conv"


def test_reduce_without_a_marked_range_reads_nothing():
    assert trace.reduce([ev("kernel", "k", 0, 10)]) is None
