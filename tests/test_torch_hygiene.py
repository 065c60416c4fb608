"""Rules of the port that hold for every module: it never imports JAX or
the JAX package, its entry points run on CUDA unless told otherwise and
never fall back to the CPU, and ``chip_smoke.py`` refuses to run without a
card or without the package."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import init_mtp_params
from repro_torch.data import make_batch_iter
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.mempool import EMSService, MemoryPool
from repro_torch.models import (build_plan, decode_step, init_params,
                                make_caches, prefill)
from repro_torch.serving import Request, ServingSystem
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.train import init_opt_state, train

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


#: modules of the MTP / EMS / serve-CLI slice, of the Zamba2 and
#: frontends slice, of the training and checkpoint slice, of the
#: parallel slice (2-D LEP, the hybrid prefill, meshes, sharding specs,
#: the roofline) and of the dry-run slice (the dry run, its variants, the
#: collective counter, the DTensor helpers), which the walk above must
#: keep covering
SLICE_MODULES = ("core/mtp.py", "mempool/context_cache.py", "mempool/ems.py",
                 "launch/serve.py", "launch/__init__.py",
                 "configs/zamba2_1_2b.py", "configs/internvl2_2b.py",
                 "configs/hubert_xlarge.py", "mempool/model_cache.py",
                 "data/__init__.py", "data/pipeline.py", "train/__init__.py",
                 "train/loop.py", "train/optimizer.py",
                 "checkpoint/__init__.py", "checkpoint/ckpt.py",
                 "launch/train.py", "core/parallel.py",
                 "core/hybrid_parallel.py", "core/lep.py", "launch/mesh.py",
                 "launch/sharding.py", "launch/roofline.py",
                 "launch/dryrun.py", "launch/variants.py",
                 "launch/collectives.py", "dtensor.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"):
            bad += [a.value for a in node.args if isinstance(
                a, ast.Constant) and isinstance(a.value, str)
                and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_checked(module):
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_model():
    cfg = smoke_variant(get_config("deepseek-r1"))
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("entry", ["init_params", "make_caches",
                                   "PrefillEngine", "DecodeEngine",
                                   "ServingSystem", "init_mtp_params",
                                   "serve_cli", "train", "init_opt_state",
                                   "save_checkpoint", "load_checkpoint",
                                   "train_cli"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                           cpu_model, entry,
                                                           tmp_path):
    cfg, params = cpu_model
    calls = {
        "init_params": lambda: init_params(cfg, seed=0),
        "make_caches": lambda: make_caches(cfg, 1, 8),
        "PrefillEngine": lambda: PrefillEngine(params, cfg, 16),
        "DecodeEngine": lambda: DecodeEngine(params, cfg, 2, 16),
        "ServingSystem": lambda: ServingSystem(params, cfg, capacity=16),
        "init_mtp_params": lambda: init_mtp_params(cfg),
        "serve_cli": lambda: serve_cli.main(["--arch", "deepseek-r1"]),
        "train": lambda: train(params, cfg, make_batch_iter(
            cfg.vocab_size, 8, 2), 1),
        "init_opt_state": lambda: init_opt_state(params),
        "save_checkpoint": lambda: save_checkpoint(str(tmp_path), params, 0),
        "load_checkpoint": lambda: load_checkpoint(str(tmp_path), cfg),
        "train_cli": lambda: train_cli.main(["--arch", "granite-3-2b"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_trained_model_serves_without_building_a_graph(capsys):
    """``train`` turns gradients on for its steps alone: afterwards every
    weight is frozen again, and prefill, decode and a serve build no
    autograd graph."""
    cfg = smoke_variant(get_config("granite-3-2b"))
    model = init_params(cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    model, _ = train(model, cfg, make_batch_iter(cfg.vocab_size, 16, 2), 2,
                     device="cpu")
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
    assert not any(p.requires_grad for p in model.parameters())
    logits, caches = prefill(model, cfg, {"tokens": torch.tensor([[1, 2, 3]])},
                             8)
    step, _ = decode_step(model, cfg, torch.tensor([[4]]), caches,
                          torch.tensor(3))
    assert logits.grad_fn is None and step.grad_fn is None
    results = ServingSystem(model, cfg, capacity=16, device="cpu").serve(
        [Request(0, [1, 2, 3], 3)])
    assert len(results[0].tokens) == 3


def test_engine_refuses_params_on_another_device(cpu_model):
    cfg, params = cpu_model
    with pytest.raises(ValueError, match="lives on"):
        DecodeEngine(params, cfg, 2, 16, device="meta")


def test_later_slices_raise(cpu_model):
    """No landed slice raises any more: the 2-D LEP modes build over a mesh
    (the 1-D API refuses them, asking for one), and MTP, the EMS context
    cache, GQA attention, the Zamba2 hybrid and the frontends run."""
    cfg, params = cpu_model
    from repro_torch.core import lep
    with pytest.raises(ValueError, match="mesh="):
        lep.make_lep_moe_fn(ffn_gather="tokens")
    for change, kinds in ((dict(attention_kind="bidirectional",
                                frontend="audio_frames"), ["dense", "moe"]),
                          (dict(ssm_state=16, attn_every=2),
                           ["mamba_groups"]),
                          (dict(frontend="vision_patches"), ["dense", "moe"])):
        assert [s.kind for s in build_plan(
            dataclasses.replace(cfg, **change))] == kinds
    assert not hasattr(serve_cli, "UNPORTED_ARCHS")
    ServingSystem(params, cfg, capacity=16, use_mtp=True, mtp_fused=True,
                  mtp_params=init_mtp_params(cfg, device="cpu"),
                  context_cache=EMSService(MemoryPool(n_nodes=2),
                                           block_tokens=8,
                                           model_tag=cfg.name),
                  device="cpu")


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert out.stdout == ""
