"""On the card: every cell at its own size on three seeds, the program's
numbers within their limits and the lower-precision control's not (a short
window: what decides ``correct`` is read after it). Run with
``python -m pytest amt_bench/tests -m card``."""

import pytest

from amt_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEEDS = (2024_0001, 2024_0002, 2024_0003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    from amt_bench import controls

    seconds = 10.0 if cell.startswith("amt-") else 2.0
    for seed in SEEDS:
        program, control, _ = controls.readings(cell, seed, seconds)
        assert all(v <= lim for _, v, lim, _ in program), (seed, program)
        assert any(v > lim for _, v, lim, _ in control), (seed, control)
