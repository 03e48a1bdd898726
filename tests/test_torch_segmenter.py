"""The port's segmenter (shmgan_tpu_torch/train/segmenter.py) against the JAX
package's (shmgan_tpu/train/segmenter.py): `segment_plan`, and
`AdaptiveSegmenter` on hypothesis-drawn ladders, budgets, caps, initial
lengths and runs of (length, wall) observations, equal after every one;
`run` under a fake clock; the refusals. Pure Python, exact equality. And
the port's `run_segments`: a stop read before each segment after the
first."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from shmgan_tpu.train import segmenter as J
from shmgan_tpu_torch.train import segmenter as P

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True, database=None)

ladders = st.lists(st.integers(1, 500), min_size=1, max_size=8)
observations = st.lists(
    st.tuples(st.integers(-2, 600),
              st.one_of(st.floats(-1.0, 120.0, allow_nan=False), st.just(0.0))),
    max_size=25)


def _state(seg):
    return (seg.current, seg.per_step_s, seg._ceiling, seg.observations, seg.summary(),
            seg.plan(0, 1), seg.plan(3, 37), seg.plan(11, 1000))


def test_default_ladder_is_jaxs():
    assert P.DEFAULT_LADDER == J.DEFAULT_LADDER


@SETTINGS
@given(st.integers(0, 10_000), st.integers(0, 2_000), st.integers(-3, 700))
def test_segment_plan_matches_jax(start, k, seg):
    plan = P.segment_plan(start, k, seg)
    assert plan == J.segment_plan(start, k, seg)
    if k:
        assert sum(n for _, n in plan) == k and plan[0][0] == start


@SETTINGS
@given(st.one_of(st.none(), ladders), st.floats(0.01, 60.0), st.floats(0.0, 60.0),
       st.integers(-5, 1000), observations)
def test_adaptive_segmenter_matches_jax_after_every_observation(ladder, budget, extra_cap,
                                                               init, obs):
    kw = dict(budget_s=budget, hard_cap_s=budget + extra_cap, init_steps=init)
    if ladder is not None:
        kw["ladder"] = ladder
    port, jax_seg = P.AdaptiveSegmenter(**kw), J.AdaptiveSegmenter(**kw)
    assert port.ladder == jax_seg.ladder and _state(port) == _state(jax_seg)
    for length, wall in obs:
        # lengths the plan gives, and others, repeated, so rates and ceilings move
        for n in (length, port.current, length):
            port.observe(n, wall)
            jax_seg.observe(n, wall)
            assert _state(port) == _state(jax_seg)
    if port.per_step_s is not None and port._ceiling is None:
        fits = [r for r in port.ladder if r * port.per_step_s <= port.budget_s]
        assert port.current <= max(fits, default=port.ladder[0])


class _Clock:
    """A fake clock: each program call advances it by its length x rate."""

    def __init__(self, rates):
        self.t, self.rates = 0.0, list(rates)

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rates", [[0.5], [0.01, 0.2, 3.0], [2.0, 0.001]])
def test_run_under_a_fake_clock_matches_jax(rates):
    results = []
    for mod in (P, J):
        clock = _Clock(rates)
        seg = mod.AdaptiveSegmenter(budget_s=5.0, hard_cap_s=8.0, init_steps=10, clock=clock)
        calls, last = [], []

        def program(s0, kk, clock=clock, calls=calls):
            clock.t += kk * clock.rates[len(calls) % len(clock.rates)]
            calls.append((s0, kk))
            return {"step": s0 + kk - 1}

        done = 0
        for k in (37, 100, 100, 3, 250):
            last.append(seg.run(done, k, program, lambda r: r["step"]))
            done += k
        results.append((calls, last, seg.current, seg.per_step_s, seg._ceiling,
                        seg.summary()))
    assert results[0] == results[1]
    assert results[0][1][-1] == {"step": done - 1}   # the newest step's result


@pytest.mark.parametrize("stop_after", [None, 1, 2, 3])
def test_run_segments_stops_between_segments(stop_after):
    """Each segment runs, syncs and is observed in turn; stop() is asked
    before every segment but the first, and a true answer ends the run with
    the steps run so far and the last segment's result."""
    segments = [(4, 2), (6, 2), (8, 1)]
    events, asked = [], []

    def stop():
        asked.append(len(events))
        return stop_after is not None and len(asked) >= stop_after

    result, ran = P.run_segments(
        segments, lambda s0, kk: events.append(("run", s0, kk)) or s0 + kk,
        lambda r: events.append(("sync", r)), lambda kk, wall: events.append(("observe", kk)),
        stop, clock=lambda: 0.0)
    n = len(segments) if stop_after is None or stop_after >= len(segments) else stop_after
    assert ran == sum(kk for _, kk in segments[:n])
    assert result == segments[n - 1][0] + segments[n - 1][1]
    assert events == [e for s0, kk in segments[:n]
                      for e in (("run", s0, kk), ("sync", s0 + kk), ("observe", kk))]
    assert len(asked) == min(n, len(segments) - 1)


@pytest.mark.parametrize("kw", [dict(budget_s=0.0), dict(budget_s=-1.0),
                                dict(budget_s=30.0, hard_cap_s=20.0), dict(ladder=()),
                                dict(ladder=(0, 5)), dict(ladder=(-3,))])
def test_refusals_match_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        J.AdaptiveSegmenter(**kw)
    with pytest.raises(ValueError) as port_err:
        P.AdaptiveSegmenter(**kw)
    assert str(port_err.value) == str(jax_err.value)
