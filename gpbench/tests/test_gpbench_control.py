"""Each cell's control, in the program's place one precision below the
configuration's, comes out not correct: the bootstrap's answers as the
reference's own maxima evaluated in float32 (the refine states float64),
the observed chains as the port's float32 exploration (they state
float64).  On the chip the same control runs at the cells' sizes
(``python -m gpbench.readings --control-seeds``)."""
import pytest

from gpbench_tiny import run_tiny


@pytest.mark.parametrize("cell", ["gauss.bootstrap", "gauss.observed", "lognormal.bootstrap"])
def test_the_control_is_not_correct(cell):
    res = run_tiny(cell, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
