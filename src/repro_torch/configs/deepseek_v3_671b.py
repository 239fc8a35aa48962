"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import DEEPSEEK_V3_671B as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
