"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import QWEN2_1P5B as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
