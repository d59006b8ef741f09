"""The port stands alone: importing every module of ``fvsrn_tpu_torch``
loads neither ``jax`` nor ``fvsrn_tpu``, no file of the port (nor
``chip_smoke.py``) names them, and none reaches into the JAX package's
native code (the port builds its own copy of the LZ4 codec)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fvsrn_tpu_torch")

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fvsrn_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "fvsrn_tpu"))
print(len(sys.modules), bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


IMPORT_ONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "fvsrn_tpu"))
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", ["fvsrn_tpu_torch.ops.fused_dvr",
                                    "fvsrn_tpu_torch.raytracer.iso",
                                    "fvsrn_tpu_torch.ops.fused_eval",
                                    "fvsrn_tpu_torch.raytracer.montecarlo",
                                    "fvsrn_tpu_torch.raytracer.evaluator",
                                    "fvsrn_tpu_torch.train.world",
                                    "fvsrn_tpu_torch.train.importance",
                                    "fvsrn_tpu_torch.train.main",
                                    "fvsrn_tpu_torch.volume.lz4io",
                                    "fvsrn_tpu_torch.volume.volume",
                                    "fvsrn_tpu_torch.volume.grid",
                                    "fvsrn_tpu_torch.modules.registry",
                                    "fvsrn_tpu_torch.brdf",
                                    "fvsrn_tpu_torch.transfer",
                                    "fvsrn_tpu_torch.parallel.mesh",
                                    "fvsrn_tpu_torch.parallel.train_step",
                                    "fvsrn_tpu_torch.train.pose",
                                    "fvsrn_tpu_torch.train.screen",
                                    "fvsrn_tpu_torch.raytracer.rasterization",
                                    "fvsrn_tpu_torch.tools."
                                    "pose_recovery_demo"])
def test_slice_module_imports_alone(module):
    """The modules of the fused per-segment and isosurface renders, of
    Monte-Carlo path tracing, of world training, of voxel volumes and
    scene files, of data parallelism, pose recovery and rasterization
    import on their own, loading no JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ONE, module],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_name_no_jax():
    _assert_no_match(re.compile(r"\bjax\b|\bjaxlib\b|\bfvsrn_tpu\."))


def test_sources_reach_no_jax_native_code():
    """No path into the JAX package's native directory, its Makefile or
    its library: the port compiles its own ``native/lz4.cpp`` into the
    repository's build directory."""
    _assert_no_match(re.compile(r"\bfvsrn_tpu[/\\]+native|Makefile|"
                                r"libfvsrn_native"))
    from fvsrn_tpu_torch.volume import lz4io
    assert lz4io.SOURCE == os.path.join(PKG, "native", "lz4.cpp")
    assert lz4io.BUILD_DIR == os.path.join(ROOT, "build", "fvsrn_tpu_torch")


def _assert_no_match(pattern):
    files = list(_port_files())
    assert len(files) > 15
    offenders = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{n}: "
                                     f"{line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_parallel_states_its_backend():
    """``parallel`` picks no backend silently: ``nccl`` where each rank
    has a card of its own, ``gloo`` where ranks share one or run on the
    CPU; ``nccl`` asked for with two ranks on one card (which NCCL
    refuses) or on the CPU raises, before any group is made."""
    import torch
    from fvsrn_tpu_torch.parallel import mesh
    assert mesh.choose_backend("cuda", 1, 1) == "nccl"
    assert mesh.choose_backend("cuda", 4, 4) == "nccl"
    assert mesh.choose_backend("cuda", 2, 1) == "gloo"
    assert mesh.choose_backend("cpu", 2, 0) == "gloo"
    assert mesh.choose_backend("cuda", 2, 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="2 ranks on 1 card"):
        mesh.choose_backend("cuda", 2, 1, "nccl")
    with pytest.raises(ValueError, match="CPU"):
        mesh.choose_backend("cpu", 1, 0, "nccl")
    with pytest.raises(ValueError, match="CPU"):
        mesh.make_mesh(1, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
