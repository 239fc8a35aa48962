"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import MAMBA2_780M as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
