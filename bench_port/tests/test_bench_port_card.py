"""The control of each serving cell on the card, at the cell's own
configuration and a pool a test run holds: the reference in float8 in the
program's place must fail the cell's limit. In the training cell the
float8 control and the planted fault, half of the batch left out, must each
fail its limits. Marked ``cuda``; the card is looked for inside the
fixture.

    python -m pytest -p no:cacheprovider bench_port/tests -m cuda -q
"""

import pytest
import torch

from bench_port import check, control, registry

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _cells(kind):
    bench = registry.load_benchmark()
    return [w["name"] for w in bench["workloads"]
            if registry.cell(w["name"], bench).traffic["kind"] == kind]


@pytest.mark.parametrize("name", _cells("serve"))
def test_serving_control_fails_its_limit(card, name):
    cell = registry.cell(name, registry.load_benchmark())
    cell.traffic = dict(cell.traffic, pool_clips=16)
    got = control.serve_readings(cell, 2 ** 31 + 17, card)["control"]
    ok, table = check.compare(got, cell.limits)
    assert not ok, table


@pytest.mark.parametrize("reading", ["control", "half_batch"])
@pytest.mark.parametrize("name", _cells("train"))
def test_training_control_and_half_batch_fail_their_limits(card, name, reading):
    cell = registry.cell(name, registry.load_benchmark())
    got = control.train_readings(cell, 2 ** 31 + 17, card)
    ok, table = check.compare(got[reading], cell.limits)
    assert not ok, table
