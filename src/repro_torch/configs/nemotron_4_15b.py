"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import NEMOTRON_4_15B as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
