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
# one intra-op thread: the suite runs its files in parallel workers, and
# the port's small CPU ops lose more to thread hand-offs than they gain
torch.set_num_threads(1)

from repro_torch import device as rdev  # noqa: E402
from repro_torch.core.egrl import EGRL, EGRLConfig  # noqa: E402
from repro_torch.graphs.zoo import resnet50  # noqa: E402
from repro_torch.launch import optimize_placement  # noqa: E402
from repro_torch.launch import serve_placements  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.memsim import compiler  # noqa: E402
from repro_torch.serving.placement_service import (  # noqa: E402
    PlacementService)

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
    service = {"configs.granite_3_8b", "configs.llama3_405b",
               "configs.qwen2_5_14b", "configs.llama4_maverick_400b_a17b",
               "configs.qwen3_moe_30b_a3b", "configs.chameleon_34b",
               "configs.seamless_m4t_medium", "graphs.extract",
               "graphs.hashing", "obs.log", "obs.metrics", "obs.trace",
               "checkpoint.manager", "serving.placement_service",
               "launch.serve_placements"}
    assert {f"repro_torch.{m}" for m in service} <= set(MODULES)
    assert (PORT / "obs" / "__init__.py").exists()
    training = {"training.optimizers", "training.train_step",
                "training.remat", "data.pipeline",
                "distributed.compression", "launch.train"}
    assert {f"repro_torch.{m}" for m in training} <= set(MODULES)


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_placement.optimize("granite-3-8b", "decode_32k", steps=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlacementService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_placements.serve([], pop_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_placements.main(["--requests", "1"])
    from repro_torch.configs.registry import get_config, smoke_config
    small = smoke_config(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.TrainLoop(small)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    assert train_launch.TrainLoop(small, device="cpu").device.type == "cpu"
    assert PlacementService(device="cpu").device == torch.device("cpu")
    assert rdev.resolve_device("cpu") == torch.device("cpu")
    algo = EGRL(resnet50(), EGRLConfig(total_steps=20), device="cpu")
    assert algo.gnn_pop.device.type == "cpu"


def test_other_modes_and_llm_archs_say_what_is_missing():
    # every mode of the reference runs; an unknown one lists them
    with pytest.raises(ValueError, match="egrl, ea, pg"):
        EGRL(resnet50(), EGRLConfig(), mode="sac", device="cpu")
    # an LLM id is extracted at its shape and searched ...
    plan, _ = optimize_placement.optimize("granite-3-8b", "decode_32k",
                                          steps=20, device="cpu")
    assert plan["graph_nodes"] == 202 and len(plan["ops"]) == 202
    # ... and a shape its family does not support raises, as in JAX
    with pytest.raises(KeyError, match="long_500k"):
        optimize_placement.optimize("granite-3-8b", "long_500k", steps=20,
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
                                    "flash_attention_tc": 0,
                                    "flash_attention_bwd": 0,
                                    "flash_attention_bwd_tc": 0,
                                    "ssd_scan": 0, "ssd_scan_bwd": 0}


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
                          "flash_attention_bwd", "ssd_scan")}
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


def test_kernel_load_from_two_threads_builds_once(monkeypatch, tmp_path):
    """``load`` called from two threads at once (the placement service's
    refinement threads) runs the compiler once, each thread writing its
    own temporary file, and both get the same library; nothing is built
    for real (a stub stands in for nvcc and for the loader)."""
    import threading
    import time
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    started = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.tmp = cmd[cmd.index("-o") + 1]
            time.sleep(0.2)         # both threads inside the build window

        def communicate(self):
            with open(self.tmp, "w") as f:
                f.write("lib")
            return "ptxas info    : Used 8 registers", None

    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.load("memsim"))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(started) == 1 and got[0] == got[1]
    tmp = started[0][started[0].index("-o") + 1]
    assert any(tmp.endswith(f".{os.getpid()}.{t.ident}.tmp")
               for t in threads)
    assert build.library_path("memsim").exists()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_launch_counts_exact_under_threads():
    import sys
    import threading
    from repro_torch.memsim import simulator
    rdev.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            rdev.count_launch(simulator.evaluate_population)
            for _ in range(2000)]) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert rdev.launch_counts()["memsim"] == 16000
    rdev.reset_launch_counts()


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
