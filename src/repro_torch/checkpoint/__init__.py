from repro_torch.checkpoint.checkpoint import latest_step, load, save, verify

__all__ = ["save", "load", "latest_step", "verify"]
