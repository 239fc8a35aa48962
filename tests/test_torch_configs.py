"""The port's per-model config modules (``repro_torch.configs.<name>``)
against the JAX package's: each module's ``CONFIG`` and its ``SMOKE``
(``reduced(CONFIG)``) are equal, field by field."""
import dataclasses
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(p.stem for p in (ROOT / "src" / "repro" / "configs").glob(
    "*.py") if p.stem not in ("__init__", "archs", "base"))


def test_every_config_module_is_ported():
    ported = {p.stem for p in
              (ROOT / "src" / "repro_torch" / "configs").glob("*.py")}
    assert len(NAMES) == 10 and set(NAMES) <= ported


@pytest.mark.parametrize("name", NAMES)
def test_config_module_matches_jax(name):
    jm = importlib.import_module(f"repro.configs.{name}")
    tm = importlib.import_module(f"repro_torch.configs.{name}")
    for attr in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(tm, attr)) == \
            dataclasses.asdict(getattr(jm, attr))
    assert tm.CONFIG.name != tm.SMOKE.name
