from repro_torch.models.registry import (ModelAPI, count_params,
                                         dummy_inputs, frontend_shape,
                                         get_model, param_bytes, text_seq_len)

__all__ = ["ModelAPI", "get_model", "dummy_inputs", "frontend_shape",
           "text_seq_len", "count_params", "param_bytes"]
