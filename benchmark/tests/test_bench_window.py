"""The window's arithmetic: completed jobs only, the window ending at
the synchronisation that ends the last one, and the statistics."""

import pytest

from benchmark.harness import window


class Clock:
    """A clock that each job advances by its own duration."""

    def __init__(self, durations):
        self.now, self.durations = 100.0, list(durations)

    def __call__(self):
        return self.now

    def job(self, i):
        self.now += self.durations[i]


def test_closed_loop_counts_whole_jobs_and_ends_at_the_last():
    clock = Clock([3.0, 4.0, 5.0, 6.0])
    done, secs, times = window.closed_loop(clock.job, 10.0, clock)
    # The third job ends past 10 s: it counts, and the window ends there.
    assert (done, secs, times) == (3, 12.0, [3.0, 4.0, 5.0])
    assert window.rate(done * 4_147_200, secs) == pytest.approx(
        3 * 4_147_200 / 12.0)


def test_one_long_job_still_makes_a_window():
    clock = Clock([30.0])
    assert window.closed_loop(clock.job, 10.0, clock) == (1, 30.0, [30.0])


def test_quantile_and_the_values_beyond_it():
    values = [float(v) for v in range(1, 101)]
    assert window.quantile(values, 0.9) == pytest.approx(90.1)
    assert window.beyond(values, 0.9) == 10
    assert window.quantile([5.0], 0.9) == 5.0
