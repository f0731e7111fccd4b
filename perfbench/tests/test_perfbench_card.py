"""A short run of the headline cell on the card (skips without one).

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""

import pytest


@pytest.mark.cuda
def test_headline_cell_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import run

    line = run.main(["--workload", "vcolor.train.2048x8", "--seed", "2147483713",
                     "--seconds", "2"])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
