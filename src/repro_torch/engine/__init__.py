from repro_torch.engine.engine import (MorphServeEngine, EngineConfig,
                                       KVQuantConfig, RequestKVState)
from repro_torch.engine.kv_cache import (PagedKVPool, BlockAllocator,
                                         PrefixCache, kv_block_bytes)
from repro_torch.engine.cost_model import (CostModel, HardwareProfile,
                                           NVIDIA_L4, NVIDIA_A100_80G,
                                           NVIDIA_H100_SXM, TPU_V5E, PROFILES)
from repro_torch.engine.metrics import ServingReport, build_report
from repro_torch.engine.request import Request, RState
from repro_torch.engine.traces import (TraceRequest, SLOClass, SLO_CLASSES,
                                       DEFAULT_SLO_CLASS, azure_like,
                                       burstgpt_like, constant_rate,
                                       shared_prefix_multiturn,
                                       mixed_class_traffic, diurnal_ramp,
                                       long_prompt_flood,
                                       multi_tenant_prefix_pollution,
                                       TRACES)
