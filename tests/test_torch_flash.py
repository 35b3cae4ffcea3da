"""The port's flash attention (plain version, CPU) against the JAX
Pallas kernel run in interpret mode (``repro.kernels.flash_attention``,
as tests/test_kernels.py runs it) and against the JAX
``blocked_attention``.  Inputs are unit normal from a numpy seed;
tolerances are 2e-5 in f32 (sums in another order) and 2e-2 in bf16
(the Pallas kernel rounds q * scale once, the JAX and port code twice).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(128, 2, 2, 64), (256, 1, 4, 128), (512, 4, 1, 32), (64, 2, 2, 16),
          (100, 2, 2, 32)]


def _inputs(S, K, G, h, dtype, seed=0, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, K, G, h)).astype(np.float32)
    k = rng.standard_normal((B, S, K, h)).astype(np.float32)
    v = rng.standard_normal((B, S, K, h)).astype(np.float32)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tx


def _err(port, ref):
    return float(np.abs(port.float().numpy()
                        - np.asarray(ref.astype(jnp.float32))).max())


@pytest.mark.parametrize("S,K,G,h", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_interpret(S, K, G, h, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(S, K, G, h, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("S,chunk,offset", [(128, 32, 0), (100, 100, 0),
                                            (64, 16, 16), (256, 64, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_attention_matches_jax(S, chunk, offset, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S, 2, 2, 16, dtype, seed=S)
    want = jatt.blocked_attention(jq, jk, jv, chunk=chunk, causal=True,
                                  kv_offset=offset)
    got = att.blocked_attention(q, k, v, chunk=chunk, causal=True,
                                kv_offset=offset)
    assert _err(got, want) < TOL[dtype]
    # the models pass the positions themselves
    pos = att.blocked_attention(q, k, v, chunk=chunk, causal=True,
                                q_positions=torch.arange(S) + offset,
                                kv_offset=offset)
    assert torch.equal(pos, got)


def test_blocked_attention_takes_only_contiguous_positions():
    _, (q, k, v) = _inputs(32, 1, 2, 16, "float32")
    with pytest.raises(ValueError, match="arange"):
        att.blocked_attention(q, k, v, chunk=32, causal=True,
                              q_positions=torch.arange(32).flip(0))
    with pytest.raises(AssertionError):
        att.blocked_attention(q, k, v, chunk=24, causal=True)
