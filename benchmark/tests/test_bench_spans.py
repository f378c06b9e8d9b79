"""The readers of the program's spans (benchmark/metrics/
geometry_idle_ms.retrain.py, engine_idle_ms.score.py) on hand-made
breakdowns, and the trace's labelling of an idle gap by the program range
open at its middle."""

import types

import pytest

from benchmark import core, trace

geometry = core.reader("geometry_idle_ms.retrain")
engine = core.reader("engine_idle_ms.score")


def ctx(idle_gaps, units=1):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(breakdown={"idle_gaps": idle_gaps}),
        traced_units=units)


def test_geometry_idle_is_its_label_per_traced_call():
    gaps = [["shorter gaps", 0.06], ["retrain.geometry", 0.05],
            ["retrain.step", 0.004], ["aten::convolution", 0.002]]
    assert geometry(ctx(gaps)) == pytest.approx(50.0)
    assert geometry(ctx(gaps, units=2)) == pytest.approx(25.0)


def test_geometry_idle_absent_label():
    # the program's spans label gaps, none this one: 0
    assert geometry(ctx([["retrain.step", 0.01], ["aten::mm", 0.1]])) == 0.0
    # no span of the program at all (a program without them): nothing
    assert geometry(ctx([["host Python, no torch operation", 0.05]])) \
        is None


def test_engine_idle_sums_every_score_label_per_traced_pass():
    gaps = [["shorter gaps", 0.009], ["score.stage2", 0.002],
            ["cudaMemcpyAsync", 0.004], ["score.chunk", 0.0015],
            ["score.fetch", 0.0005], ["retrain.step", 1.0]]
    assert engine(ctx(gaps)) == pytest.approx(4.0)
    assert engine(ctx(gaps, units=2)) == pytest.approx(2.0)
    assert engine(ctx([["host Python, no torch operation", 0.006]])) is None


def test_summary_labels_a_gap_by_the_program_range_open_at_its_middle():
    """Host ranges: the harness's window and unit, the program's call and
    its geometry, then a step in which a torch operation runs.  The card
    idles during the geometry and inside the operation."""
    ev = [("bench.window", False, 0, 200), ("bench.unit", False, 0, 200),
          ("retrain.call", False, 2, 198),
          ("retrain.geometry", False, 5, 60),
          ("retrain.step", False, 60, 190),
          ("aten::convolution", False, 120, 150),
          ("k_fwd", True, 70, 120), ("k_bwd", True, 140, 200)]
    s = trace.summarize(ev)
    assert s.breakdown["idle_gaps"] == [["retrain.geometry", 70e-9],
                                        ["aten::convolution", 20e-9]]
    assert geometry(types.SimpleNamespace(trace=s, traced_units=1)) \
        == pytest.approx(70e-6)
