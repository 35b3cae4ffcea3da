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
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

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


# ---------------------------------------------------------------- routes
def _served():
    from repro_torch.configs.registry import get_config
    return [get_config(n) for n in ("zamba2-1.2b", "qwen3-0.6b")]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-0.6b"])
@pytest.mark.parametrize("S", [100, 512, 2048])
def test_served_bf16_shapes_take_the_tensor_cores(arch, S):
    cfg = {c.name: c for c in _served()}[arch]
    assert cfg.dtype == "bfloat16"
    q = torch.zeros((1, S, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim),
                    dtype=torch.bfloat16)
    k = torch.zeros((1, S, cfg.n_kv_heads, cfg.head_dim),
                    dtype=torch.bfloat16)
    assert ops.kernel_route(q, k, k) == "tensor_cores"
    # the f32 prefill of the same heads stays on the fp32 cores
    assert ops.kernel_route(q.float(), k.float(), k.float()) == "fp32_cores"


@pytest.mark.parametrize("h,dtype,route", [
    (16, torch.bfloat16, "fp32_cores"), (32, torch.bfloat16, "fp32_cores"),
    (64, torch.bfloat16, "tensor_cores"), (128, torch.bfloat16,
                                           "tensor_cores"),
    (16, torch.float32, "fp32_cores"), (64, torch.float32, "fp32_cores"),
    (128, torch.float32, "fp32_cores")])
def test_route_by_dtype_and_head_dim(h, dtype, route):
    q = torch.zeros((1, 8, 2, 2, h), dtype=dtype)
    k = torch.zeros((1, 8, 2, h), dtype=dtype)
    assert ops.kernel_route(q, k, k) == route


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_misaligned_storage_offset_raises(which):
    shapes = {"q": (1, 64, 2, 2, 64), "k": (1, 64, 2, 64),
              "v": (1, 64, 2, 64)}
    x = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    n = x[which].numel()
    # a contiguous view 2 bytes into its storage: TMA cannot read it
    x[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(
        shapes[which])
    assert x[which].is_contiguous() and x[which].storage_offset() == 1
    with pytest.raises(ValueError, match="16 bytes"):
        ops.kernel_route(x["q"], x["k"], x["v"])
    # 8 elements (16 bytes) in is aligned
    x[which] = torch.zeros(n + 8, dtype=torch.bfloat16)[8:].view(
        shapes[which])
    assert ops.kernel_route(x["q"], x["k"], x["v"]) == "tensor_cores"


def test_route_rejects_what_neither_kernel_takes():
    q = torch.zeros((1, 8, 1, 1, 48), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ops.kernel_route(q, k, k)
    q = torch.zeros((1, 8, 1, 1, 64), dtype=torch.float16)
    k = torch.zeros((1, 8, 1, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.kernel_route(q, k, k)


class _FakeLib:
    """Stands in for the built library: records which C entry each launch
    calls and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def function(self, lib, name, argtypes):
        def fn(*args):
            self.calls.append(name)
            return self.err
        return fn


@pytest.mark.parametrize("h,dtype,entry", [
    (64, torch.bfloat16, "flash_attention_fwd_tc"),
    (128, torch.bfloat16, "flash_attention_fwd_tc"),
    (32, torch.bfloat16, "flash_attention_fwd"),
    (64, torch.float32, "flash_attention_fwd")])
def test_launch_takes_one_route_and_counts_it(monkeypatch, h, dtype, entry):
    from repro_torch import device as rdev
    lib = _FakeLib()
    monkeypatch.setattr(ops.build, "function", lib.function)
    monkeypatch.setattr(ops.build, "cuda_call",
                        lambda fn, q, *args: fn(*args, 0))
    q = torch.zeros((1, 16, 2, 2, h), dtype=dtype)
    k = torch.zeros((1, 16, 2, h), dtype=dtype)
    rdev.reset_launch_counts()
    ops._launch(q, k, k, True, 0)
    assert lib.calls == [entry]
    counts = rdev.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_tc"] == int(entry.endswith("_tc"))
    rdev.reset_launch_counts()
    assert rdev.launch_counts()["flash_attention_tc"] == 0


def test_failed_tensor_core_launch_raises_without_fallback(monkeypatch):
    from repro_torch import device as rdev
    lib = _FakeLib(err=1001)
    monkeypatch.setattr(ops.build, "function", lib.function)
    monkeypatch.setattr(ops.build, "cuda_call",
                        lambda fn, q, *args: fn(*args, 0))
    q = torch.zeros((1, 16, 2, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    rdev.reset_launch_counts()
    with pytest.raises(RuntimeError, match="tensor-core kernel launch"):
        ops._launch(q, k, k, True, 0)
    assert lib.calls == ["flash_attention_fwd_tc"]
    assert rdev.launch_counts()["flash_attention"] == 0
