"""The paper's three workloads rebuilt as graphs: ResNet-50 (57 nodes),
ResNet-101 (108 nodes), BERT (376 nodes). Node counts match §4.

Copy of ``src/repro/graphs/zoo.py``, unchanged apart from its import.

Shapes are ImageNet-224 inference (batch 1) for the ResNets and seq-384
batch-1 inference for BERT; weights/activations in bf16 (the NNP-I runs
int8 — tier *ratios* are what matter for placement, and those carry over).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.graphs.graph import Node, WorkloadGraph


def _conv(cin, cout, hw_in, k, stride=1, groups=0) -> Node:
    hw_out = hw_in // stride
    flops = 2.0 * cin * cout * k * k * hw_out * hw_out
    return Node(op="conv", weight_bytes=2.0 * cin * cout * k * k,
                ifm=(hw_in, hw_in, cin), ofm=(hw_out, hw_out, cout),
                flops=flops, kernel=(k, k), stride=stride,
                pad=k // 2, groups=groups)


def _resnet(blocks_per_stage: List[int], name: str) -> WorkloadGraph:
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    hw, c = 224, 3
    i = add(Node(op="input", ifm=(224, 224, 3), ofm=(224, 224, 3)), [])
    i = add(_conv(3, 64, 224, 7, stride=2), [i])
    hw, c = 112, 64
    i = add(Node(op="pool", ifm=(hw, hw, c), ofm=(hw // 2, hw // 2, c),
                 flops=hw * hw * c, kernel=(3, 3), stride=2), [i])
    hw = 56
    width = 64
    for stage, n_blocks in enumerate(blocks_per_stage):
        cout = width * 4
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            inp = i
            sc = (add(_conv(c, cout, hw, 1, stride=stride), [inp])
                  if b == 0 else inp)  # projection vs identity shortcut
            j1 = add(_conv(c, width, hw, 1, stride=stride), [inp])
            j2 = add(_conv(width, width, hw // stride, 3), [j1])
            j3 = add(_conv(width, cout, hw // stride, 1), [j2, sc])
            i = j3
            hw //= stride
            c = cout
        width *= 2
    i = add(Node(op="pool", ifm=(hw, hw, c), ofm=(1, 1, c), flops=hw * hw * c,
                 kernel=(hw, hw)), [i])
    add(Node(op="fc", weight_bytes=2.0 * c * 1000, ifm=(1, 1, c),
             ofm=(1, 1, 1000), flops=2.0 * c * 1000), [i])
    g = WorkloadGraph(name, nodes, edges)
    g.validate()
    return g


def resnet50() -> WorkloadGraph:
    return _resnet([3, 4, 6, 3], "resnet50")      # 57 nodes


def resnet101() -> WorkloadGraph:
    return _resnet([3, 4, 23, 3], "resnet101")    # 108 nodes


def bert(seq: int = 384, layers: int = 12, d: int = 768,
         heads: int = 8) -> WorkloadGraph:
    """BERT-base encoder, op-granular (~388 nodes; the paper reports 376 —
    the small delta is NNP-I-compiler-specific op decomposition)."""
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    hd = d // heads
    i = add(Node(op="embed", weight_bytes=2.0 * 30522 * d, ifm=(seq, 1, 1),
                 ofm=(seq, 1, d), flops=seq * d,
                 weight_access_frac=seq / 30522.0), [])
    i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d, ifm=(seq, 1, d),
                 ofm=(seq, 1, d), flops=5.0 * seq * d), [i])
    for _ in range(layers):
        inp = i
        q = add(Node(op="qkv", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), [inp])
        k = add(Node(op="qkv", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), [inp])
        v = add(Node(op="qkv", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), [inp])
        heads_nodes = []
        for h in range(heads):  # per-head attention ops (paper-scale graph)
            s_ = add(Node(op="attn", ifm=(seq, 1, hd), ofm=(seq, seq, 1),
                          flops=2.0 * seq * seq * hd, groups=heads), [q, k])
            sm = add(Node(op="softmax", ifm=(seq, seq, 1), ofm=(seq, seq, 1),
                          flops=5.0 * seq * seq), [s_])
            av = add(Node(op="attn", ifm=(seq, seq, 1), ofm=(seq, 1, hd),
                          flops=2.0 * seq * seq * hd), [sm, v])
            heads_nodes.append(av)
        o = add(Node(op="o_proj", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), heads_nodes)
        n1 = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d,
                      ifm=(seq, 1, d), ofm=(seq, 1, d), flops=5.0 * seq * d),
                 [o, inp])
        f1 = add(Node(op="mlp", weight_bytes=2.0 * d * 4 * d, ifm=(seq, 1, d),
                      ofm=(seq, 1, 4 * d), flops=2.0 * seq * d * 4 * d), [n1])
        f2 = add(Node(op="mlp", weight_bytes=2.0 * 4 * d * d,
                      ifm=(seq, 1, 4 * d), ofm=(seq, 1, d),
                      flops=2.0 * seq * d * 4 * d), [f1])
        i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=5.0 * seq * d), [f2, n1])
    i = add(Node(op="fc", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                 ofm=(1, 1, d), flops=2.0 * d * d), [i])
    add(Node(op="fc", weight_bytes=2.0 * d * 2, ifm=(1, 1, d), ofm=(1, 1, 2),
             flops=2.0 * d * 2), [i])
    g = WorkloadGraph("bert", nodes, edges)
    g.validate()
    return g


# ------------------------------------------------- beyond-paper workloads
# 1k+-node synthetic graphs exercising the O(N * W) ring rectifier and
# the padded GraphBatch path at the scale they were built for (ROADMAP
# "larger-than-BERT workloads").  Both are op-granular like the paper
# graphs; node counts are asserted >= 1000 in tests/test_zoo_egrl.py.

def moe_transformer(seq: int = 256, layers: int = 26, d: int = 1024,
                    heads: int = 8, experts: int = 8,
                    top_k: int = 2) -> WorkloadGraph:
    """Deep MoE decoder stack, per-head attention ops (~40 nodes/layer,
    1043 nodes at the defaults).  Expert banks are weight-heavy but
    stream only ``top_k / experts`` of their bytes per inference
    (``weight_access_frac``), the placement trade-off that makes MoE
    interesting for a memory mapper: huge cold weights vs hot router
    activations."""
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    hd = d // heads
    ffd = 4 * d
    i = add(Node(op="embed", weight_bytes=2.0 * 50304 * d, ifm=(seq, 1, 1),
                 ofm=(seq, 1, d), flops=seq * d,
                 weight_access_frac=seq / 50304.0), [])
    i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d, ifm=(seq, 1, d),
                 ofm=(seq, 1, d), flops=5.0 * seq * d), [i])
    for _ in range(layers):
        inp = i
        qkv = [add(Node(op="qkv", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                        ofm=(seq, 1, d), flops=2.0 * seq * d * d), [inp])
               for _ in range(3)]
        q, k, v = qkv
        head_outs = []
        for _ in range(heads):
            s_ = add(Node(op="attn", ifm=(seq, 1, hd), ofm=(seq, seq, 1),
                          flops=2.0 * seq * seq * hd, groups=heads), [q, k])
            sm = add(Node(op="softmax", ifm=(seq, seq, 1), ofm=(seq, seq, 1),
                          flops=5.0 * seq * seq), [s_])
            av = add(Node(op="attn", ifm=(seq, seq, 1), ofm=(seq, 1, hd),
                          flops=2.0 * seq * seq * hd), [sm, v])
            head_outs.append(av)
        o = add(Node(op="o_proj", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), head_outs)
        n1 = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d,
                      ifm=(seq, 1, d), ofm=(seq, 1, d), flops=5.0 * seq * d),
                 [o, inp])
        router = add(Node(op="moe_router", weight_bytes=2.0 * d * experts,
                          ifm=(seq, 1, d), ofm=(seq, 1, experts),
                          flops=2.0 * seq * d * experts), [n1])
        bank = [add(Node(op="expert_bank",
                         weight_bytes=2.0 * 2 * d * ffd,
                         ifm=(seq, 1, d), ofm=(seq, 1, d),
                         flops=2.0 * seq * d * ffd * 2 * top_k / experts,
                         weight_access_frac=top_k / experts),
                    [n1, router]) for _ in range(experts)]
        comb = add(Node(op="add", ifm=(seq, 1, d), ofm=(seq, 1, d),
                        flops=seq * d * top_k), bank)
        i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d,
                     ifm=(seq, 1, d), ofm=(seq, 1, d), flops=5.0 * seq * d),
                [comb, n1])
    add(Node(op="lm_head", weight_bytes=2.0 * d * 50304, ifm=(seq, 1, d),
             ofm=(1, 1, 50304), flops=2.0 * d * 50304), [i])
    g = WorkloadGraph("moe_transformer", nodes, edges)
    g.validate()
    return g


def dense_cnn(blocks: int = 8, layers_per_block: int = 62,
              growth: int = 32, hw: int = 28) -> WorkloadGraph:
    """DenseNet-style dense-fan-in CNN (1010 nodes at the defaults):
    every layer's 1x1 bottleneck consumes ALL previous activations in
    its block, so activation lifetimes span whole blocks (big release
    fan-in, ring width W in the hundreds) — the adversarial shape for
    the rectifier's release-credit ring."""
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    i = add(Node(op="input", ifm=(hw * 2, hw * 2, 3), ofm=(hw * 2, hw * 2, 3)),
            [])
    i = add(_conv(3, 2 * growth, hw * 2, 3, stride=2), [i])
    c = 2 * growth
    for b in range(blocks):
        feeds = [i]          # activations visible inside this block
        for _ in range(layers_per_block):
            cin = c + growth * (len(feeds) - 1)
            j = add(_conv(cin, 4 * growth, hw, 1), list(feeds))
            j = add(_conv(4 * growth, growth, hw, 3), [j])
            feeds.append(j)
        c = c + growth * layers_per_block
        if b < blocks - 1:   # transition: 1x1 compress + stride-2 pool
            i = add(_conv(c, c // 2, hw, 1), list(feeds))
            c = c // 2
            i = add(Node(op="pool", ifm=(hw, hw, c),
                         ofm=(max(hw // 2, 4), max(hw // 2, 4), c),
                         flops=float(hw * hw * c), kernel=(2, 2), stride=2),
                    [i])
            hw = max(hw // 2, 4)
        else:
            i = add(Node(op="pool", ifm=(hw, hw, c), ofm=(1, 1, c),
                         flops=float(hw * hw * c), kernel=(hw, hw)),
                    list(feeds))
    add(Node(op="fc", weight_bytes=2.0 * c * 1000, ifm=(1, 1, c),
             ofm=(1, 1, 1000), flops=2.0 * c * 1000), [i])
    g = WorkloadGraph("dense_cnn", nodes, edges)
    g.validate()
    return g


# ------------------------------------------------------ small workloads
# <200-node graphs giving the zoo real small-size classes: without them
# the BucketedZoo (graphs/bucketed.py) has nothing to peel away from the
# 1k-node synthetics, and the padding-tax win is untestable.

def _dwconv(c, hw_in, k, stride=1) -> Node:
    """Depthwise conv: per-channel kernels (groups == channels)."""
    hw_out = hw_in // stride
    return Node(op="conv", weight_bytes=2.0 * c * k * k,
                ifm=(hw_in, hw_in, c), ofm=(hw_out, hw_out, c),
                flops=2.0 * c * k * k * hw_out * hw_out,
                kernel=(k, k), stride=stride, pad=k // 2, groups=c)


def mobilenet_v2() -> WorkloadGraph:
    """MobileNet-V2-style inverted-residual CNN (65 nodes): tiny weights,
    activation-dominated — the opposite placement regime from the
    weight-heavy transformers, in the smallest zoo size class."""
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    i = add(Node(op="input", ifm=(224, 224, 3), ofm=(224, 224, 3)), [])
    i = add(_conv(3, 32, 224, 3, stride=2), [i])
    hw, c = 112, 32
    # (expand t, c_out, repeats, first stride) per stage, per the paper
    for t, cout, reps, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                             (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                             (6, 320, 1, 1)):
        for b in range(reps):
            stride = s if b == 0 else 1
            inp, hidden = i, c * t
            j = add(_conv(c, hidden, hw, 1), [inp]) if t != 1 else inp
            j = add(_dwconv(hidden, hw, 3, stride), [j])
            j = add(_conv(hidden, cout, hw // stride, 1), [j])
            if stride == 1 and c == cout:    # identity residual
                j = add(Node(op="add", ifm=(hw, hw, c), ofm=(hw, hw, c),
                             flops=float(hw * hw * c)), [inp, j])
            i, hw, c = j, hw // stride, cout
    i = add(_conv(c, 1280, hw, 1), [i])
    i = add(Node(op="pool", ifm=(hw, hw, 1280), ofm=(1, 1, 1280),
                 flops=float(hw * hw * 1280), kernel=(hw, hw)), [i])
    add(Node(op="fc", weight_bytes=2.0 * 1280 * 1000, ifm=(1, 1, 1280),
             ofm=(1, 1, 1000), flops=2.0 * 1280 * 1000), [i])
    g = WorkloadGraph("mobilenet_v2", nodes, edges)
    g.validate()
    return g


def tiny_gpt(seq: int = 128, layers: int = 6, d: int = 512,
             heads: int = 4) -> WorkloadGraph:
    """GPT-style decoder stack at toy scale (123 nodes at the defaults):
    the BERT op mix one size class down, so the small buckets carry a
    transformer shape too, not just CNNs.  ~55 MB of weights — more
    than VMEM holds — so constant fast-tier mappings still spill (the
    rectifier's capacity pressure exists even in the small bucket);
    ``mobilenet_v2`` is the opposite: it fits a fast tier whole."""
    nodes: List[Node] = []
    edges: List[Tuple[int, int]] = []

    def add(node: Node, srcs: List[int]) -> int:
        idx = len(nodes)
        nodes.append(node)
        for s in srcs:
            edges.append((s, idx))
        return idx

    hd = d // heads
    i = add(Node(op="embed", weight_bytes=2.0 * 8192 * d, ifm=(seq, 1, 1),
                 ofm=(seq, 1, d), flops=seq * d,
                 weight_access_frac=seq / 8192.0), [])
    i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d, ifm=(seq, 1, d),
                 ofm=(seq, 1, d), flops=5.0 * seq * d), [i])
    for _ in range(layers):
        inp = i
        q, k, v = (add(Node(op="qkv", weight_bytes=2.0 * d * d,
                            ifm=(seq, 1, d), ofm=(seq, 1, d),
                            flops=2.0 * seq * d * d), [inp])
                   for _ in range(3))
        head_outs = []
        for _ in range(heads):
            s_ = add(Node(op="attn", ifm=(seq, 1, hd), ofm=(seq, seq, 1),
                          flops=2.0 * seq * seq * hd, groups=heads), [q, k])
            sm = add(Node(op="softmax", ifm=(seq, seq, 1), ofm=(seq, seq, 1),
                          flops=5.0 * seq * seq), [s_])
            av = add(Node(op="attn", ifm=(seq, seq, 1), ofm=(seq, 1, hd),
                          flops=2.0 * seq * seq * hd), [sm, v])
            head_outs.append(av)
        o = add(Node(op="o_proj", weight_bytes=2.0 * d * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=2.0 * seq * d * d), head_outs)
        n1 = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d,
                      ifm=(seq, 1, d), ofm=(seq, 1, d), flops=5.0 * seq * d),
                 [o, inp])
        f1 = add(Node(op="mlp", weight_bytes=2.0 * d * 4 * d, ifm=(seq, 1, d),
                      ofm=(seq, 1, 4 * d), flops=2.0 * seq * d * 4 * d), [n1])
        f2 = add(Node(op="mlp", weight_bytes=2.0 * 4 * d * d,
                      ifm=(seq, 1, 4 * d), ofm=(seq, 1, d),
                      flops=2.0 * seq * d * 4 * d), [f1])
        i = add(Node(op="norm_proj", weight_bytes=2.0 * 2 * d, ifm=(seq, 1, d),
                     ofm=(seq, 1, d), flops=5.0 * seq * d), [f2, n1])
    add(Node(op="lm_head", weight_bytes=2.0 * d * 8192, ifm=(seq, 1, d),
             ofm=(1, 1, 8192), flops=2.0 * d * 8192), [i])
    g = WorkloadGraph("tiny_gpt", nodes, edges)
    g.validate()
    return g


PAPER_WORKLOADS = {"resnet50": resnet50, "resnet101": resnet101, "bert": bert}
SYNTH_WORKLOADS = {"moe_transformer": moe_transformer, "dense_cnn": dense_cnn}
SMALL_WORKLOADS = {"mobilenet_v2": mobilenet_v2, "tiny_gpt": tiny_gpt}
# the full registry the workload-batch subsystem (graphs/batch.py,
# graphs/bucketed.py, benchmarks bench_zoo_eval) evaluates against
WORKLOADS = {**PAPER_WORKLOADS, **SYNTH_WORKLOADS, **SMALL_WORKLOADS}

# lazy per-workload size cache: (n_nodes, ring_width W) per registry
# name, built on first request WITHOUT constructing a SimGraph (the
# graph object itself is built once and dropped — only the two ints are
# kept), so size-bucketing decisions over the whole registry stay cheap.
_SIZE_CACHE: dict = {}


def workload_sizes(name: str) -> Tuple[int, int]:
    """(node count, release-ring width) of a registry workload, cached."""
    if name not in _SIZE_CACHE:
        g = WORKLOADS[name]()
        _SIZE_CACHE[name] = (g.n, g.ring_width())
    return _SIZE_CACHE[name]
