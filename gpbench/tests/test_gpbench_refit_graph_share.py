"""``refit_graph_share``'s reader on canned records: the replayed steps'
share of the refits' steps on a card, nothing from a port without the
counter or from the host."""
from types import SimpleNamespace

import pytest
import torch

from gpbench.run import PACKAGE_DIR, load_module


def _read(device, records):
    ctx = SimpleNamespace(device=torch.device(device), records=records, dirs=[PACKAGE_DIR])
    return load_module(ctx.dirs, "metrics", "refit_graph_share").read(ctx)


def test_the_share_of_replayed_steps():
    with_counter = [{"sims": 1023, "timings": {"refit_steps": 1352, "refit_graph_steps": 1348}},
                    {"sims": 1023, "timings": {"refit_steps": 1340, "refit_graph_steps": 1336}}]
    assert _read("cuda", with_counter) == pytest.approx((1348 + 1336) / (1352 + 1340))
    without = [{"sims": 1023, "timings": {"refit_steps": 1352}}] * 2
    assert _read("cuda", without) is None
    assert _read("cpu", with_counter) is None
