"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and its entry points refuse to run on a machine without
CUDA unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as rdev  # noqa: E402
from repro_torch.core.egrl import EGRL, EGRLConfig  # noqa: E402
from repro_torch.graphs.zoo import resnet50  # noqa: E402
from repro_torch.launch import optimize_placement  # noqa: E402
from repro_torch.memsim import compiler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 34
    serving = {"configs.base", "configs.registry", "configs.zamba2_1_2b",
               "configs.mamba2_780m", "configs.qwen3_0_6b", "utils.params",
               "kernels.flash_attention.ops", "kernels.ssd_scan.ops",
               "models.common", "models.attention", "models.mamba2",
               "models.transformer", "models.zamba2", "models.zoo",
               "serving.engine", "launch.serve"}
    assert {f"repro_torch.{m}" for m in serving} <= set(MODULES)
    zoo = {"utils.envpolicy", "graphs.batch", "graphs.bucketed",
           "memsim.batch", "launch.train_zoo"}
    assert {f"repro_torch.{m}" for m in zoo} <= set(MODULES)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_reference_imports(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import jax|from jax|import repro\.|"
                     r"from repro\.|from repro import|import repro$)",
                     text, flags=re.M)
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rdev.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EGRL(resnet50(), EGRLConfig(total_steps=20))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_placement.optimize("resnet50", "-", steps=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compiler.compiler_reference(resnet50())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compiler.greedy_dp(resnet50(), passes=1)
    assert rdev.resolve_device("cpu") == torch.device("cpu")
    algo = EGRL(resnet50(), EGRLConfig(total_steps=20), device="cpu")
    assert algo.gnn_pop.device.type == "cpu"


def test_other_modes_and_llm_archs_say_what_is_missing():
    # every mode of the reference runs; an unknown one lists them
    with pytest.raises(ValueError, match="egrl, ea, pg"):
        EGRL(resnet50(), EGRLConfig(), mode="sac", device="cpu")
    with pytest.raises(NotImplementedError, match="config port"):
        optimize_placement.optimize("granite-3-8b", "decode_32k", steps=20,
                                    device="cpu")


def test_cpu_run_launches_no_kernel():
    """Two "egrl" generations: the second trains SAC, through the GAT
    backward, on CPU tensors only."""
    rdev.reset_launch_counts()
    algo = EGRL(resnet50(), EGRLConfig(total_steps=40), mode="egrl",
                device="cpu")
    algo.train()
    assert "critic_loss" in algo.history[-1]
    assert rdev.launch_counts() == {"gat_mp": 0, "gat_mp_bwd": 0,
                                    "memsim": 0, "memsim_zoo": 0,
                                    "flash_attention": 0,
                                    "flash_attention_tc": 0, "ssd_scan": 0}


def test_optimize_writes_the_reference_plan_schema():
    plan, algo = optimize_placement.optimize("resnet50", "decode_32k",
                                             steps=40, device="cpu")
    # two "egrl" generations: 20 population rollouts and 1 PG rollout each
    assert plan["graph_nodes"] == 57 and plan["env_steps"] == 42
    assert plan["mode"] == "egrl"
    assert len(plan["ops"]) == 57
    assert set(plan["ops"][0]) == {"index", "op", "weight_tier", "act_tier",
                                   "weight_bytes", "act_bytes"}
    assert plan["speedup_vs_compiler"] == pytest.approx(
        algo.best_reward / algo.cfg.reward_scale, rel=1e-6)
    assert set(plan["derived"]) == {"act_resident_frac", "suggested_remat"}


def test_kernel_build_names_and_missing_toolkit(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    paths = {name: build.library_path(name)
             for name in ("gat_mp", "gat_mp_bwd", "memsim", "flash_attention",
                          "ssd_scan")}
    for name, path in paths.items():
        assert path.parent == ROOT / "build" / "repro_torch"
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    # the simulator is built without FMA contraction, the GAT kernel is not
    assert "-fmad=false" in build._flags("memsim")
    assert "-fmad=false" not in build._flags("gat_mp")
    assert "-fmad=false" not in build._flags("gat_mp_bwd")
    for name in paths:
        assert "arch=compute_90a,code=sm_90a" in build._flags(name)
    # no toolkit: the build says so instead of falling back
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["gat_mp"])
    assert not (tmp_path / "build").exists()


def test_library_path_follows_shared_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh header gives every source a new library path,
    so a stale library is never loaded; an unrelated file does not."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k")
    (tmp_path / "notes.txt").write_text("not a header")
    assert build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)
