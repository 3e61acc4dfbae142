from repro_torch.serving.block_allocator import AllocatorStats, BlockAllocator
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.request import Phase, Request, SamplingParams
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
