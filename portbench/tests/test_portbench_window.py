"""The window's arithmetic."""

import pytest

from portbench import window


def test_rate_is_steps_over_the_whole_window():
    assert window.rate(450, 10.0) == 45.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


@pytest.mark.parametrize("n,expected", [(1, 1), (19, 19), (20, 19), (21, 20), (100, 95), (101, 96)])
def test_p95_by_nearest_rank(n, expected):
    values = list(range(1, n + 1))[::-1]
    assert window.percentile_nearest_rank(values, 95) == expected


def test_block_step_times_partition_the_block():
    marks, end = [0.0, 2.0, 5.0, 6.5], 10.0
    ms = window.block_step_ms(marks, end)
    assert ms == [2.0, 3.0, 1.5, 3.5] and sum(ms) == end - marks[0]
