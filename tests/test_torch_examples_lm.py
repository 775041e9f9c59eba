"""The LM examples' twins (``python -m repro_torch.examples.serve_lm`` and
``train_tiny_lm``) as scripts on the CPU.

Each runs in a subprocess with ``--device cpu`` that loads neither jax nor
anything of ``repro``.  serve_lm's greedy decode is deterministic (its own
``assert``) for a MoE, a VLM and an encoder-decoder architecture;
train_tiny_lm's loss falls (its own ``assert``).  Their tokens and losses
are not the reference example's: the port draws its weights from a
``torch.Generator``.  The models are held to the reference, weights carried
across, in ``tests/test_torch_serve_engine.py`` and
``tests/test_torch_train.py``.  Without ``--device`` and without a GPU
they exit non-zero: ``tests/test_torch_examples.py``.
"""
import re

import pytest

from tests.test_torch_examples import run_twin


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-vl-72b",
                                  "seamless-m4t-large-v2"])
def test_serve_twin_runs_on_cpu(arch):
    lines = run_twin("serve_lm", ["--arch", arch, "--batch", "2",
                                  "--tokens", "8", "--device", "cpu"])
    assert lines[0].startswith(f"{arch} (reduced): batch=2 generated 16 "
                               "tokens")
    sample = re.fullmatch(r"sample: \[([\d, ]+)\]", lines[1])
    assert sample and len(sample.group(1).split(",")) == 8


def test_train_twin_loss_falls_on_cpu():
    lines = run_twin("train_tiny_lm", ["--steps", "10", "--batch", "2",
                                       "--seq", "32", "--device", "cpu"])
    assert lines[0].startswith("model: ") and "6L x d384" in lines[0]
    first, last = (float(x) for x in re.match(
        r"loss: ([\d.]+) -> ([\d.]+)", lines[-1]).groups())
    assert last < first


def test_train_twin_returns_its_losses():
    """``main`` returns one loss a step (``chip_smoke.py`` holds them)."""
    from repro_torch.examples import train_tiny_lm
    losses = train_tiny_lm.main(["--steps", "4", "--batch", "1", "--seq",
                                 "16", "--device", "cpu"])
    assert len(losses) == 4 and losses[-1] < losses[0]
