"""``core/gat_tune.py``, the block-shape tuner of the GAT kernels, on the
CPU: the plain route and its cache, the plain version timed for the
record and never chosen, ``blocks_for`` without timing, the CUDA
candidates' dedupe (a pure function of N and the device kind), the
``gat_autotune`` span, a block shape outside the compiled sets raising,
and the GNN forward and SAC losses through the resolved route against
JAX's (``test_torch_gnn.py`` / ``test_torch_sac.py``'s tolerances).  The
CUDA timing and the bit-equality of every shape run on the card
(``chip_smoke.py``'s gat, gat_bwd and gat_tune phases)."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers
torch.set_num_threads(1)

from repro_torch import obs  # noqa: E402
from repro_torch.core import gat_tune  # noqa: E402
from repro_torch.kernels.gat_mp import ops  # noqa: E402

import test_torch_gnn  # noqa: E402
import test_torch_sac  # noqa: E402
from test_torch_sac import setup  # noqa: E402,F401  (the SAC fixture)

F32 = torch.float32


def test_cpu_resolves_to_the_plain_version_and_caches():
    kw = dict(batch=1, masks=1, device="cpu")
    t = gat_tune.autotune(57, 128, 4, F32, **kw)
    assert t.backend == "plain" and t.blocks is None and t.timings == {}
    assert gat_tune.autotune(57, 128, 4, F32, **kw) is t
    # another batch, mask count or device is another key
    assert gat_tune._cache_key(57, 128, 4, F32, 2, 1, "cpu") != \
        gat_tune._cache_key(57, 128, 4, F32, 1, 1, "cpu")
    assert gat_tune._cache_key(57, 128, 4, F32, 1, 1, "cpu") != \
        gat_tune._cache_key(57, 128, 4, F32, 1, 2, "cpu")


def test_plain_version_timed_for_the_record_never_chosen():
    t = gat_tune.autotune(31, 128, 4, F32, batch=2, masks=1, device="cpu",
                          force_time=True, include_dense=True)
    assert t.backend == "plain" and t.blocks is None
    assert t.timings["plain"]["fwd_us"] > 0
    assert t.timings["plain"]["fwd_bwd_us"] > t.timings["plain"]["fwd_us"]
    # a cache hit that was timed is returned as it is
    assert gat_tune.autotune(31, 128, 4, F32, batch=2, masks=1,
                             device="cpu", include_dense=True) is t
    # on a card the plain version's entry is never eligible, however fast
    timings = {"plain": {"fwd_us": 0.1, "fwd_bwd_us": 0.2, "bwd_us": 0.1},
               "fwd_w2": {"fwd_us": 9.0}, "fwd_w4": {"fwd_us": 7.5},
               "fwd_w8": {"fwd_us": 8.0},
               "bwd_w4_r256_b2": {"bwd_us": 21.0},
               "bwd_w8_r512_b1": {"bwd_us": 20.0}}
    assert gat_tune.choose(timings, "fwd") == (4,)
    assert gat_tune.choose(timings, "bwd") == (8, 512, 1)


def test_blocks_for_gives_the_default_without_timing():
    before = dict(gat_tune._CACHE)
    with obs.override(mode="mem"):
        obs.drain()
        got = gat_tune.blocks_for(401, 128, 4, F32, batch=3, masks=3,
                                  device="cpu")
        spans = [e for e in obs.drain() if e.get("type") == "span"]
    assert got == gat_tune.DEFAULT_BLOCKS == {"fwd": (4,),
                                              "bwd": (8, 512, 2)}
    assert gat_tune._CACHE == before and spans == []
    assert gat_tune.DEFAULT_BLOCKS["fwd"][0] in ops.FWD_WARPS
    assert gat_tune.DEFAULT_BLOCKS["bwd"] in ops.BWD_SHAPES


@pytest.mark.parametrize("n", [8, 57, 97, 256, 388, 1043])
def test_cuda_candidates_dedupe_effective_shapes(n):
    cands = gat_tune.candidates(n, "cuda")
    assert gat_tune.candidates(n, "cpu") == {"fwd": [], "bwd": []}
    for kind, compiled, eff in (
            ("fwd", [(w,) for w in ops.FWD_WARPS], gat_tune.effective_fwd),
            ("bwd", list(ops.BWD_SHAPES), gat_tune.effective_bwd)):
        kept = cands[kind]
        assert kept == sorted(kept) and set(kept) <= set(compiled)
        # one shape per effective shape, and every compiled one covered
        assert len({eff(n, s) for s in kept}) == len(kept)
        assert {eff(n, s) for s in compiled} == {eff(n, s) for s in kept}
        # the smallest shape of each effective shape is the one kept
        for s in compiled:
            assert min(c for c in compiled if eff(n, c) == eff(n, s)) in kept
    # every row fits in the 256-row listing up to N = 256: the 512-row
    # shapes of 2 edges a gather act as the 256-row ones
    assert len(cands["bwd"]) == (4 if n <= 256 else 6)
    assert len(cands["fwd"]) == 3


def test_small_graphs_have_one_candidate_and_skip_timing():
    assert gat_tune.candidates(1, "cuda") == {"fwd": [(2,)],
                                              "bwd": [(4, 256, 2)]}
    assert gat_tune.candidates(3, "cuda")["fwd"] == [(2,), (4,)]


def test_span_records_the_choice():
    with obs.override(mode="mem"):
        obs.drain()
        gat_tune.autotune(23, 64, 2, F32, batch=1, masks=1, device="cpu",
                          force_time=True)
        spans = [e for e in obs.drain() if e.get("type") == "span"
                 and e["name"] == "gat_autotune"]
    assert len(spans) == 1
    attrs = spans[0]["attrs"]
    assert attrs["chosen"] == "plain"
    assert (attrs["n"], attrs["d"], attrs["heads"], attrs["batch"],
            attrs["masks"], attrs["dtype"]) == (23, 64, 2, 1, 1, "float32")


def test_unknown_block_shape_raises():
    z = torch.zeros(1, 8, 128)
    es = torch.zeros(1, 8, 4)
    adj = torch.ones(1, 8, 8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no kernel of 3 warps"):
        ops._launch(z, es, es, adj, warps=3)
    with pytest.raises(RuntimeError, match=r"no kernel of block shape"):
        ops._launch_bwd(z, es, es, adj, es, es, z, z, shape=(8, 128, 2))


@pytest.mark.parametrize("name", ["resnet50", "bert"])
def test_gnn_forward_through_the_resolved_route(name):
    """``gnn._gat`` resolves every level's key (the plain route on the
    CPU) before its launch, and the forward still matches JAX's."""
    gat_tune._CACHE.clear()
    test_torch_gnn.test_population_logits_match_jax(name)
    keys = [k for k in gat_tune._CACHE if k[-1] == "cpu"]
    g = test_torch_gnn.zoo.WORKLOADS[name]()
    sizes = {g.n, max(2, g.n // 2), max(2, g.n // 4)}
    assert {k[0] for k in keys} == sizes
    assert all(gat_tune._CACHE[k].backend == "plain" for k in keys)


def test_sac_losses_through_the_resolved_route(setup):  # noqa: F811
    """The critic loss (B noisy actions, one shared mask) and the actor
    loss through the resolved route, against JAX's losses on the dense
    GAT backend, to ``test_torch_sac.py``'s tolerances."""
    import jax.numpy as jnp
    gat_tune._CACHE.clear()
    jl, port, feats, adj = setup
    jf, ja = jnp.asarray(feats), jnp.asarray(adj)
    acts, rews, noise = test_torch_sac._batch(1, feats.shape[0])
    oh = test_torch_sac._onehot(acts, noise)
    jloss = test_torch_sac._jax_critic_loss(jf, ja)(
        jl.critic, jnp.asarray(oh), jnp.asarray(rews))
    with torch.no_grad():
        loss = port.critic_loss(port.critic, torch.as_tensor(oh),
                                torch.as_tensor(rews))
        aloss, ent = port.actor_loss(port.actor, port.critic)
    jaloss, jent = test_torch_sac._jax_actor_loss(jl, jf, ja)(jl.actor,
                                                             jl.critic)
    tol = test_torch_sac.Q_TOL
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=tol)
    assert float(aloss) == pytest.approx(float(jaloss), rel=1e-5, abs=tol)
    assert float(ent) == pytest.approx(float(jent), rel=1e-5)
    # the critic's key (B transitions, one shared mask) and the actor's
    keys = list(gat_tune._CACHE)
    assert any(k[4] == test_torch_sac.B and k[5] == 1 for k in keys)
    assert any(k[4] == 1 and k[5] == 1 for k in keys)
    assert all(gat_tune._CACHE[k].backend == "plain" for k in keys)
