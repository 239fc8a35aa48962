"""Assigned architecture config (see archs.py for dims + provenance)."""
from repro_torch.configs.archs import WHISPER_SMALL as CONFIG
from repro_torch.configs.archs import reduced

SMOKE = reduced(CONFIG)
