"""Core: the paper's contribution (predictive multi-tier KV cache management)."""
from repro_torch.core.sizing import (per_token_layer_bytes, mha_equivalent_bytes,
                               seq_bytes, total_bytes, max_batch,
                               status_quo_max_batch, block_tokens,
                               block_bytes, sizing_report)
from repro_torch.core.bayesian import BayesianReusePredictor, BLOCK_TYPES, TRANSITION_TYPES
from repro_torch.core.tiers import (TierHierarchy, TierManager, TierSpec, RDMATier,
                              ConsistentHashRing, PAPER_TIER_SPECS,
                              TPU_V5E_TIER_SPECS, CapacityError)
from repro_torch.core.eviction import (HeadImportanceTracker, BlockMeta, LRUPolicy,
                                 EMAPolicy, BayesianPolicy, POLICIES)
from repro_torch.core.prefetch import RoPEPrefetcher, PrefetchRequest
from repro_torch.core.dedup import (ContentStore, RadixTree, content_hash,
                              payload_hash, delta_checkpoint, CheckpointManifest)
from repro_torch.core.agentic import (MarkovToolPredictor, ToolProfile,
                                SessionFeatures, classify_session)
from repro_torch.core.policy import PlacementPolicy, PlacementDecision
from repro_torch.core.cache_manager import PredictiveCacheManager, AccessResult
