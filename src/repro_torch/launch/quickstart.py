"""Quickstart on the port: the paper's technique end to end.

Builds the ResNet-50 workload graph (57 nodes, as in §4), runs a short
EGRL search (EA population + SAC learner) against the memory-tier
simulator, and prints the found placement's speedup over the heuristic
compiler.  Mirrors ``examples/quickstart.py``.

    python -m repro_torch.launch.quickstart [--device cpu]
"""
import argparse

from repro_torch.core.egrl import EGRL, EGRLConfig
from repro_torch.graphs.zoo import resnet50
from repro_torch.memsim import tiers as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    graph = resnet50()
    print(f"workload: {graph.name}, {graph.n} nodes "
          f"(action space 3^{2 * graph.n} ~ 10^{int(2 * graph.n * 0.477)})")

    algo = EGRL(graph, EGRLConfig(total_steps=400, seed=0), mode="egrl",
                device=args.device)
    algo.train(log=print)

    print(f"\nbest speedup vs compiler: "
          f"{algo.best_reward / algo.cfg.reward_scale:.3f}x")
    tiers = [t.name for t in T.TIERS]
    w = algo.best_mapping[:, 0]
    a = algo.best_mapping[:, 1]
    for k in range(3):
        print(f"  {tiers[k]:5s}: {int((w == k).sum()):3d} weight tensors, "
              f"{int((a == k).sum()):3d} activation tensors")


if __name__ == "__main__":
    main()
