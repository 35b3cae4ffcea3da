"""The port's serving engine against the JAX engine on the same
parameters (converted with ``convert.lm_params_from_jax``): 5 requests
over 2 slots, as tests/test_serving.py drives the JAX engine, give the
same tokens per request and the same ``stats()`` counts.  The launcher
runs on the CPU and launches no kernel there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke  # noqa: E402
from repro.models.zoo import get_model as jax_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as rdev  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.zoo import get_model  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402


def _serve(engine_cls, request_cls, model, params, prompts, max_new):
    eng = engine_cls(model, params, slots=2, max_len=48)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=max_new))
    done = eng.run_until_drained()
    return {r.rid: r.tokens for r in done}, eng.stats()


@pytest.mark.parametrize("arch,layers", [("qwen3-0.6b", 2),
                                         ("zamba2-1.2b", 5)])
def test_engine_matches_jax_engine(arch, layers):
    jcfg = jax_smoke(jax_config(arch)).replace(n_layers=layers)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = get_model(smoke_config(get_config(arch)).replace(n_layers=layers))
    m.load(convert.lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(0)
    # prompt lengths differ, so the uniform-pos simplification is exercised
    prompts = [rng.integers(0, jcfg.vocab_size, n, dtype=np.int32)
               for n in (6, 9, 6, 12, 7)]
    want, jstats = _serve(JaxEngine, JaxRequest, jm, jp, prompts, 4)
    got, stats = _serve(Engine, Request, m, m.params, prompts, 4)
    assert got == want
    assert all(len(t) == 4 for t in got.values()) and len(got) == 5
    assert {k: stats[k] for k in ("requests", "tokens")} == \
        {k: jstats[k] for k in ("requests", "tokens")} == \
        {"requests": 5, "tokens": 20}


def test_serve_launcher_runs_on_cpu_without_kernels():
    rdev.reset_launch_counts()
    out = serve.main(["--arch", "zamba2-1.2b", "--requests", "3",
                      "--max-new", "5", "--device", "cpu"])
    assert len(out["done"]) == 3
    assert all(len(r.tokens) == 5 for r in out["done"])
    assert out["stats"]["tokens"] == 15
    assert [n for n, _ in out["engine"].prefill_s] == [
        len(r.prompt) for r in sorted(out["done"], key=lambda r: r.rid)]
    counts = rdev.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd_scan"] == 0
    assert set(counts.values()) == {0}


def test_serve_flags(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve("qwen3-0.6b", requests=1)
    # the MoE model serves at smoke size on the CPU, launching nothing
    rdev.reset_launch_counts()
    out = serve.serve("qwen3-moe-30b-a3b", requests=2, max_new=3,
                      device="cpu")
    assert [len(r.tokens) for r in out["done"]] == [3, 3]
    assert out["cfg"].moe is not None and out["stats"]["tokens"] == 6
    assert set(rdev.launch_counts().values()) == {0}
    # the engine takes token prompts, the encdec family frame embeddings
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        serve.serve("seamless-m4t-medium", requests=1, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])
