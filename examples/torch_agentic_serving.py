"""Agentic workload demo on the PyTorch port (paper §III-G):
tool-calling sessions drive the Markov transition predictor; tool
contexts are reused across sessions via the content-addressed store.
Runs on the CUDA card (``--device cpu`` runs the kernels' plain
versions on the host).

    PYTHONPATH=src python examples/torch_agentic_serving.py
        [--device cpu] [--full-width]

``--full-width`` serves llama3.2-1b at its published width and depth
with the KV budget scaled to hold as many blocks (``width_config``).
"""
import argparse

import numpy as np

from repro_torch.core.agentic import SessionFeatures, classify_session
from repro_torch.launch.serve import width_config
from repro_torch.models.common import device_line, resolve_device
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

TOOLS = ["search", "fetch", "calc"]


def run(full_width: bool = False, device=None, params=None) -> str:
    """Run the demo; returns the text it printed."""
    out = []

    def say(*parts):
        line = " ".join(map(str, parts))
        print(line)
        out.append(line)

    device = resolve_device(device)
    say(device_line(device))
    cfg, budget = width_config("llama3.2-1b", full_width, 32e6)
    eng = ServingEngine(cfg, EngineConfig(max_len=512,
                                          kv_budget_bytes=budget),
                        params=params, device=device)
    rng = np.random.default_rng(2)
    agent_sys = [int(t) for t in rng.integers(0, 200, size=128)]
    tool_ctx = {t: [int(x) for x in rng.integers(0, 200, size=128)]
                for t in TOOLS}
    # ReAct-ish: search -> fetch -> calc, repeated across 3 sessions
    for s in range(3):
        for step, tool in enumerate(["search", "fetch", "fetch", "calc"]):
            scratch = [int(x) for x in rng.integers(0, 200, size=16)]
            eng.submit(agent_sys + tool_ctx[tool] + scratch,
                       params=SamplingParams(max_new_tokens=4),
                       session_id=f"agent{s}", block_type="tool_context",
                       tool=tool)
    eng.run()
    mk = eng.manager.agentic
    say("learned tool-transition matrix P(next | tool):")
    for t in TOOLS:
        probs = mk.transition_probs(t)
        row = "  ".join(f"{k}={v:.2f}" for k, v in sorted(probs.items()))
        say(f"  {t:7s} -> {row}")
    say("predicted next after 'search':", mk.predict_next("search", 1))
    say("pre-allocation target (bytes):",
        f"{mk.predicted_memory_demand('search'):.0f}")
    f = SessionFeatures(total_tokens=12_000, n_tool_calls=12,
                        distinct_tools=3, peak_kv_bytes=3 * 1024 ** 3)
    say("session class:", classify_session(f))
    st = eng.stats()
    eng.shutdown()
    say("prefix-hit blocks (tool ctx reused):",
        st["scheduler"]["prefix_hit_blocks"])
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="llama3.2-1b at its published width and depth")
    args = ap.parse_args(argv)
    run(args.full_width, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
