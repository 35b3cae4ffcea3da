"""The routing of the port's attention backward (``flash_attention_bwd``
in ``repro_torch.kernels.flash_attention.ops``) between the two routes of
``csrc/flash_attention_bwd.cu``: the tensor-core kernels for bf16 at
h = 64 or 128, the fp32-core kernels for everything else.  The CUDA
kernels run only on the card (``chip_smoke.py`` holds them against
``flash_attention_bwd_plain``); here the launch goes to a fake library
that records which C entry it reached, and the route is decided from
dtype, shape and alignment alone.  The plain version itself is held
against ``jax.vjp`` in ``tests/test_torch_train_ops.py``.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from repro_torch import device as rdev  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402


def _inputs(h, dtype, S=16, K=2, G=2, B=1):
    q = torch.zeros((B, S, K, G, h), dtype=dtype)
    k = torch.zeros((B, S, K, h), dtype=dtype)
    lse = torch.zeros((B, K, G, S), dtype=torch.float32)
    return q, k, k.clone(), q.clone(), lse, q.clone()


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


@pytest.fixture
def fake_lib(monkeypatch):
    def install(err=0):
        lib = _FakeLib(err)
        monkeypatch.setattr(ops.build, "function", lib.function)
        monkeypatch.setattr(ops.build, "cuda_call",
                            lambda fn, q, *args: fn(*args, 0))
        return lib
    return install


@pytest.mark.parametrize("h,dtype,route", [
    (16, torch.bfloat16, "fp32_cores"), (32, torch.bfloat16, "fp32_cores"),
    (64, torch.bfloat16, "tensor_cores"),
    (128, torch.bfloat16, "tensor_cores"),
    (16, torch.float32, "fp32_cores"), (32, torch.float32, "fp32_cores"),
    (64, torch.float32, "fp32_cores"), (128, torch.float32, "fp32_cores")])
def test_bwd_route_by_dtype_and_head_dim(h, dtype, route):
    q, k, v, out, _, g = _inputs(h, dtype)
    assert ops.bwd_route(q, k, v, out, g) == route
    # the forward's rule: the backward takes the forward's route
    assert ops.kernel_route(q, k, v) == route


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_trained_bf16_heads_take_the_tensor_cores(arch):
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    q, k, v, out, _, g = _inputs(cfg.head_dim, torch.bfloat16, S=8,
                                 K=cfg.n_kv_heads, G=cfg.q_per_kv)
    assert ops.bwd_route(q, k, v, out, g) == "tensor_cores"
    # the f32 check of the same heads (train_check) stays on the fp32 cores
    assert ops.bwd_route(*(x.float() for x in (q, k, v, out, g))) \
        == "fp32_cores"


@pytest.mark.parametrize("which", ["q", "k", "v", "out", "g"])
def test_bwd_misaligned_storage_offset_raises(which):
    x = dict(zip(("q", "k", "v", "out", "lse", "g"),
                 _inputs(64, torch.bfloat16)))
    shape, n = x[which].shape, x[which].numel()
    # a contiguous view 2 bytes into its storage: TMA cannot read it
    x[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)
    assert x[which].is_contiguous() and x[which].storage_offset() == 1
    with pytest.raises(ValueError, match="16 bytes"):
        ops.bwd_route(x["q"], x["k"], x["v"], x["out"], x["g"])
    # 8 elements (16 bytes) in is aligned
    x[which] = torch.zeros(n + 8, dtype=torch.bfloat16)[8:].view(shape)
    assert ops.bwd_route(x["q"], x["k"], x["v"], x["out"], x["g"]) \
        == "tensor_cores"


@pytest.mark.parametrize("which", ["out", "g"])
def test_misaligned_out_or_g_on_the_fp32_cores_is_taken(which):
    # the fp32-core kernels read element by element: no 16-byte rule
    x = dict(zip(("q", "k", "v", "out", "lse", "g"),
                 _inputs(32, torch.bfloat16)))
    shape, n = x[which].shape, x[which].numel()
    x[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)
    assert ops.bwd_route(x["q"], x["k"], x["v"], x["out"], x["g"]) \
        == "fp32_cores"


@pytest.mark.parametrize("h,dtype,entry", [
    (64, torch.bfloat16, "flash_attention_bwd_tc"),
    (128, torch.bfloat16, "flash_attention_bwd_tc"),
    (32, torch.bfloat16, "flash_attention_bwd"),
    (64, torch.float32, "flash_attention_bwd"),
    (128, torch.float32, "flash_attention_bwd")])
def test_launch_bwd_takes_one_route_and_counts_it(fake_lib, h, dtype,
                                                  entry):
    lib = fake_lib()
    q, k, v, out, lse, g = _inputs(h, dtype)
    rdev.reset_launch_counts()
    dq, dk, dv = ops._launch_bwd(q, k, v, out, lse, g, True, 0)
    assert lib.calls == [entry]
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    counts = rdev.launch_counts()
    assert counts["flash_attention_bwd"] == 1
    assert counts["flash_attention_bwd_tc"] == int(entry.endswith("_tc"))
    assert counts["flash_attention"] == counts["flash_attention_tc"] == 0
    rdev.reset_launch_counts()
    assert rdev.launch_counts()["flash_attention_bwd_tc"] == 0


@pytest.mark.parametrize("h,dtype,match", [
    (128, torch.bfloat16, "tensor-core kernel launch"),
    (64, torch.float32, "fp32-core kernel launch")])
def test_failed_bwd_launch_raises_without_fallback(fake_lib, h, dtype,
                                                   match):
    lib = fake_lib(err=1001)
    q, k, v, out, lse, g = _inputs(h, dtype)
    rdev.reset_launch_counts()
    with pytest.raises(RuntimeError, match=match):
        ops._launch_bwd(q, k, v, out, lse, g, True, 0)
    # one entry tried, none other after it, and nothing counted
    assert len(lib.calls) == 1
    counts = rdev.launch_counts()
    assert counts["flash_attention_bwd"] == 0
    assert counts["flash_attention_bwd_tc"] == 0


@pytest.mark.parametrize("what", ["out", "lse", "g"])
def test_launch_bwd_rejects_non_contiguous(fake_lib, what):
    lib = fake_lib()
    x = dict(zip(("q", "k", "v", "out", "lse", "g"),
                 _inputs(64, torch.bfloat16)))
    x[what] = x[what].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not x[what].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops._launch_bwd(x["q"], x["k"], x["v"], x["out"], x["lse"], x["g"],
                        True, 0)
    assert lib.calls == []


def test_cpu_backward_runs_the_plain_version_and_counts_nothing():
    rng = torch.Generator().manual_seed(0)
    q = torch.randn((1, 32, 2, 2, 64), generator=rng).bfloat16()
    k = torch.randn((1, 32, 2, 64), generator=rng).bfloat16()
    v = torch.randn((1, 32, 2, 64), generator=rng).bfloat16()
    g = torch.randn((1, 32, 2, 2, 64), generator=rng).bfloat16()
    out, lse = ops.flash_attention_plain(q, k, v, chunk=32, causal=True,
                                         return_lse=True)
    rdev.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    want = ops.flash_attention_bwd_plain(q, k, v, out, lse, g, chunk=32,
                                         causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(n == 0 for n in rdev.launch_counts().values())
