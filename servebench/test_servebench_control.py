"""The control at a size a test run holds: the plain reference computed in
float8 e4m3 (the precision step below bf16) put in the program's place
reads a widest logit gap past the limit that sound runs stay under, and
at least three times the program's, on tiny configurations of both model
families served on the CPU. ``control.py`` reads the same numbers on the
card at each cell's own size."""
import time

import pytest
import torch

from servebench import bench, check, weights


@pytest.mark.parametrize("family", ["dense", "mla"])
def test_control_fails_where_the_program_passes(tiny_repo, family):
    torch.set_num_threads(2)
    root = tiny_repo(family)
    out = bench.serve(root, "tiny.burst", 77, 4.0, False,
                      time.perf_counter(), device="cpu")
    assert out["correct"] is True
    layers = [p for _, p in weights.layer_list(out["params"],
                                               out["segments"])]
    misc = {k: v for k, v in out["params"].items() if k != "segments"}
    model = out["cell"].config["model"]
    g = check.gaps(model, layers, misc, out["picked"], out["rank"], "cpu",
                   control=True,
                   alt_margin=out["cell"].config["check"]["route_alt_margin"])
    assert len(g) == len(out["gaps"]) > 50
    control = max(d for d, _ in g)
    assert control > out["limit"]
    assert control >= 3 * out["widest"]
