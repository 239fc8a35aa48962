from repro_torch.quant.qlinear import (QTensor, quantize_tensor, is_quantized,
                                       matmul, weight_nbytes)
from repro_torch.quant.awq import (search_awq_scale, quantize_linear_awq,
                                   quantize_tree, activation_magnitude)
from repro_torch.quant import pack

__all__ = ["QTensor", "quantize_tensor", "is_quantized", "matmul",
           "weight_nbytes", "search_awq_scale", "quantize_linear_awq",
           "quantize_tree", "activation_magnitude", "pack"]
