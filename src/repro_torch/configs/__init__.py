from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      SSMConfig, ServingConfig, ShapeSpec,
                                      ALL_SHAPES, SHAPES_BY_NAME,
                                      applicable_shapes, TRAIN_4K,
                                      PREFILL_32K, DECODE_32K, LONG_500K)
from repro_torch.configs.archs import (ALL_CONFIGS, ASSIGNED, get_config,
                                       reduced, MORPH_LLAMA2_7B)
