"""The port's launchers (``repro_torch.launch.serve`` and ``.train``)
against the reference's command lines.

Each runs in-process on the CPU (``--device cpu``) on the qwen smoke
config: the serve launcher returns 0 for every engine kind and reports
the reference launcher's completion count on the same arguments; the
train launcher returns 0 with finite losses; without ``--device`` and
without a card both raise instead of falling back to the CPU.
"""
import math
import re

import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve, train

ARGS = ["--arch", "qwen2.5-0.5b", "--smoke"]


def _done_line(out):
    m = re.search(r"\] (\d+)/(\d+) done in ", out)
    assert m, out
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("kind", ["sequential", "slot", "paged"])
def test_serve_launcher_matches_reference(kind, capsys):
    args = ARGS + ["--engine", kind, "--requests", "6"]
    assert serve.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[launch.serve] arch=qwen2.5-0.5b-smoke device=cpu" in out
    assert jax_serve.main(args) == 0
    assert _done_line(out) == _done_line(capsys.readouterr().out) == (6, 6)


def test_train_launcher_runs(capsys):
    assert train.main(ARGS + ["--device", "cpu", "--steps", "2",
                              "--batch", "4", "--seq", "32"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"done: loss (\S+) -> (\S+);", out)
    assert m and all(math.isfinite(float(x)) for x in m.groups()), out


@pytest.mark.parametrize("main", [serve.main, train.main],
                         ids=["serve", "train"])
def test_launcher_without_device_needs_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ARGS + ["--steps", "1"] if main is train.main else ARGS)
