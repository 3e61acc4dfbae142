from repro_torch.serving.block_allocator import AllocatorStats, BlockAllocator
from repro_torch.serving.cluster import (LeastLoadedRouter, ReplicaCluster,
                                         RoundRobinRouter, RoutingPolicy,
                                         SessionAffinityRouter, make_router)
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.frontend import (AdmissionSnapshot, ServingFrontend,
                                          SLOConfig, StreamHandle,
                                          VirtualClock, admission_decision,
                                          projected_ttft_s)
from repro_torch.serving.kvcache import PagedKVCache, SlotKVCache
from repro_torch.serving.request import Phase, Request, SamplingParams
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
