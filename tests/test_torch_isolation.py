"""The port stands alone: no JAX, no ``repro``, and no silent CPU path."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402, F401  (the suite's other files import both packages)

from repro_torch import (RegistrationOptions, affine_register, ffd_register,  # noqa: E402
                         make_pair)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, model_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.launch.serve; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vol = torch.zeros(10, 10, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ffd_register(vol, vol)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        affine_register(vol, vol)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pair((10, 10, 10))
    cfg = get_config("gemma2-2b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        A.init_cache(cfg, 1, 8)
    # the JAX package's parameters and cache carried across land on the card
    tree = M.map_tree(lambda t: t.numpy(), M.init_model(cfg, device="cpu").tree())
    blocks = tree.pop("blocks")
    params = dict(tree, blocks={
        k: {n: np.stack([b[k][n] for b in blocks]) for n in blocks[0][k]}
        for k in blocks[0]})
    assert M.map_tree(lambda t: t.shape, model_from_numpy(cfg, params, "cpu").tree()) \
        == M.map_tree(lambda t: t.shape, M.init_model(cfg, device="cpu").tree())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_from_numpy(cfg, params)
    cache = {k: (v.float().numpy() if k != "pos" else v)
             for k, v in M.init_decode_cache(cfg, 1, 8, device="cpu").items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_from_numpy(cache)
    # generate runs where its model lies; serving from the command line
    # builds the model on the card unless --device cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma2-2b", "--smoke", "--gen", "1"])


def test_batched_and_served_registration_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import RegistrationScheduler, register_batch
    from repro_torch.launch import serve_registration

    vols = np.zeros((1, 10, 10, 10), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        register_batch(vols, vols)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RegistrationScheduler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_registration.main(["--smoke"])
    assert register_batch(vols, vols, options=RegistrationOptions(levels=1, iters=1),
                          device="cpu").warped.device.type == "cpu"
    assert RegistrationScheduler(device="cpu").device.type == "cpu"


def test_the_registration_mesh_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import torch.distributed as dist

    from repro_torch import RegistrationScheduler, register_batch
    from repro_torch.engine import make_registration_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_registration_mesh()
    assert not dist.is_initialized()  # no group was started for the refused mesh
    mesh = make_registration_mesh(device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        vols = np.zeros((1, 10, 10, 10), np.float32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            register_batch(vols, vols, mesh=mesh)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RegistrationScheduler(mesh=mesh)
        res = register_batch(vols, vols, options=RegistrationOptions(levels=1, iters=1),
                             mesh=mesh, device="cpu")
        assert res.warped.device.type == "cpu"
        assert RegistrationScheduler(mesh=mesh, device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd in (ROOT, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        run = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd,
                             env=env, capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout
