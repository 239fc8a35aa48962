"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import COMMAND_R_PLUS_104B as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
