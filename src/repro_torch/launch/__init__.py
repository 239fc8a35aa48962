"""Launch-time settings. ``knobs`` holds the model code's tunable levers
(attention tiles, the windowed-prefill switch, the remat policy), as in
the JAX package. Read them as ``knobs.KNOBS`` at call time: ``set_knobs``
rebinds it. ``launch.steps`` (imported on its own) holds the train,
prefill and serve steps and the cell shapes; ``launch.dryrun`` (with
``mesh``, ``quant_specs`` and ``step_analysis``) analyzes every cell per
device on the production meshes, on the CPU."""
from repro_torch.launch import knobs
from repro_torch.launch.knobs import VARIANTS, Knobs, reset, set_knobs

__all__ = ["knobs", "VARIANTS", "Knobs", "reset", "set_knobs"]
