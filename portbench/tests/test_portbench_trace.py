"""The trace's arithmetic: busy as the union of device intervals, the gap
after a WHILE node's test kernel, and the idle gaps named by the host."""

from portbench import trace

DEV = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("while_test_kernel", 14.0, 15.0), ("k3", 40.0, 50.0),
       ("k4", 53.0, 60.0)]
HOST = [("cudaGraphLaunch", 0.0, 100.0), ("cudaMemcpyAsync", 50.0, 55.0)]


def test_busy_is_the_union_of_overlapping_intervals():
    assert trace.merged([(5, 12), (0, 10), (14, 15)]) == [(0, 12), (14, 15)]
    assert trace.union_us((lo, hi) for _, lo, hi in DEV) == 12 + 1 + 10 + 7


def test_the_gap_after_a_while_test_is_its_body():
    assert trace.gaps_after(DEV, "while_test_kernel") == [25.0]


def test_idle_gaps_leave_out_while_bodies_and_name_the_host():
    gaps = trace.idle_gaps(DEV, HOST, busy_after="while_test_kernel")
    assert gaps == [["cudaMemcpyAsync", 3e-6], ["cudaGraphLaunch", 2e-6]]


def test_ranges_are_not_device_activities():
    class Ev:
        def __init__(self, name):
            self.name, self.device_type = name, trace._DEVICE
            self.time_range = type("R", (), {"start": 0.0, "end": 1.0})()

    annotation = Ev("a_range")
    annotation.is_user_annotation = True
    names = [e[0] for e in trace.device_events([Ev("pfs_vcycle"), annotation, Ev("k")])]
    assert names == ["k"]
