"""Prometheus-style observability (paper §IV).

"Per-tier capacity, hit rates, promotion/demotion rates, Bayesian
prediction accuracy, and per-model batch sizes are exported as Prometheus
metrics. Per-request cost tracking aggregates memory-tier-hours consumed
to compute $/Mtok."

A dependency-free registry with the text exposition format; the serving
engine and cache manager publish into it.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

_Label = Tuple[Tuple[str, str], ...]


class Registry:
    def __init__(self):
        self._gauges: Dict[Tuple[str, _Label], float] = {}
        self._counters: Dict[Tuple[str, _Label], float] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.RLock()

    @staticmethod
    def _key(name: str, labels: Optional[dict]) -> Tuple[str, _Label]:
        return name, tuple(sorted((labels or {}).items()))

    def gauge(self, name: str, value: float, labels: Optional[dict] = None,
              help: str = "") -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = float(value)
            if help:
                self._help[name] = help

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[dict] = None, help: str = "") -> None:
        with self._lock:
            k = self._key(name, labels)
            self._counters[k] = self._counters.get(k, 0.0) + float(value)
            if help:
                self._help[name] = help

    def get(self, name: str, labels: Optional[dict] = None) -> float:
        k = self._key(name, labels)
        with self._lock:
            if k in self._gauges:
                return self._gauges[k]
            return self._counters.get(k, 0.0)

    # -- text exposition format ------------------------------------------
    def expose(self) -> str:
        lines = []
        with self._lock:
            seen = set()
            for store, kind in ((self._gauges, "gauge"),
                                (self._counters, "counter")):
                for (name, labels), v in sorted(store.items()):
                    if name not in seen:
                        if name in self._help:
                            lines.append(f"# HELP {name} {self._help[name]}")
                        lines.append(f"# TYPE {name} {kind}")
                        seen.add(name)
                    if labels:
                        lab = ",".join(f'{k}="{val}"' for k, val in labels)
                        lines.append(f"{name}{{{lab}}} {v}")
                    else:
                        lines.append(f"{name} {v}")
        return "\n".join(lines) + "\n"


def publish_manager(reg: Registry, mgr, model: str = "model") -> None:
    """Publish a PredictiveCacheManager's state (paper §IV metric set)."""
    m = mgr.metrics()
    reg.gauge("kv_cache_hit_rate_hot", m["hit_rate_hot"],
              {"model": model}, help="tier 0+1 hit rate")
    reg.gauge("kv_cache_accesses_total", m["accesses"], {"model": model})
    reg.gauge("kv_cache_promotions_total", m["promotions"],
              {"model": model})
    reg.gauge("kv_cache_demotions_total", m["demotions"], {"model": model})
    reg.gauge("kv_cache_cost_dollars", m["cost_dollars"], {"model": model})
    for t in m["tiers"]:
        lab = {"model": model, "tier": t["tier"]}
        reg.gauge("kv_tier_used_bytes", t["used"], lab)
        reg.gauge("kv_tier_capacity_bytes", t["capacity"], lab)
        reg.gauge("kv_tier_reads_total", t["reads"], lab)
        reg.gauge("kv_tier_evictions_total", t["evictions"], lab)
    for pair, stats in m["predictor"].items():
        if stats["obs"] > 0:
            reg.gauge("kv_bayes_posterior_mean", stats["mean"],
                      {"model": model, "pair": pair})
