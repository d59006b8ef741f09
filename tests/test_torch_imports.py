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


# A process that has loaded numpy and torch (which every module of the
# port imports first, and which load no JAX) forks one child a module named
# on its standard input; the child imports the module alone and exits 0, or
# 1 when the import raises, or 2 when it loaded JAX or the JAX package; the
# parent answers "EXIT <code>" a module. One interpreter start for all the
# modules instead of one each (torch's import was most of each start).
IMPORT_SERVER = r"""
import importlib, os, sys, traceback
import numpy, torch
for line in sys.stdin:
    pid = os.fork()
    if pid == 0:
        try:
            importlib.import_module(line.strip())
            bad = sorted(n for n in sys.modules
                         if n.split(".")[0] in ("jax", "jaxlib", "fvsrn_tpu"))
            code = 2 if bad else 0
            if bad:
                print(bad, file=sys.stderr)
        except BaseException:
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    _, status = os.waitpid(pid, 0)
    print("EXIT", os.waitstatus_to_exitcode(status), flush=True)
"""


@pytest.fixture(scope="module")
def import_alone(tmp_path_factory):
    """``import_alone(module)``: (exit code, standard error) of importing
    ``module`` in a fresh child of IMPORT_SERVER."""
    err_path = tmp_path_factory.mktemp("imports") / "stderr.txt"
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(err_path, "w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", IMPORT_SERVER],
                                cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)

        def run(module):
            start = err.tell()
            proc.stdin.write(module + "\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            while line and not line.startswith("EXIT "):
                line = proc.stdout.readline()
            err.seek(start)
            return (int(line.split()[1]) if line else -1), err.read()

        yield run
        proc.stdin.close()
        proc.wait(timeout=60)


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
                                    "pose_recovery_demo",
                                    "fvsrn_tpu_torch.utils.timer",
                                    "fvsrn_tpu_torch.train.lpips",
                                    "fvsrn_tpu_torch.arith",
                                    "fvsrn_tpu_torch.compression",
                                    "fvsrn_tpu_torch.eval.sweep",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_network_configs",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_activation_functions",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_density_vs_color",
                                    "fvsrn_tpu_torch.eval.eval_fourier",
                                    "fvsrn_tpu_torch.eval.eval_importance",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_screen_vs_world",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_volumetric_features",
                                    "fvsrn_tpu_torch.eval."
                                    "eval_compression_teaser",
                                    "fvsrn_tpu_torch.utils.imageops",
                                    "fvsrn_tpu_torch.cli",
                                    "fvsrn_tpu_torch.models.variants",
                                    "fvsrn_tpu_torch.models.meta",
                                    "fvsrn_tpu_torch.viewer",
                                    "fvsrn_tpu_torch.eval.eval_scaling",
                                    "fvsrn_tpu_torch.eval.figures",
                                    "fvsrn_tpu_torch.convert"])
def test_slice_module_imports_alone(module, import_alone):
    """The modules of the fused per-segment and isosurface renders, of
    Monte-Carlo path tracing, of world training, of voxel volumes and
    scene files, of data parallelism, pose recovery and rasterization, of
    the evaluation harnesses, LPIPS and the compression tower, and the
    last slice's (image operations, the volume converter, the variant and
    meta networks and their converters, the viewer, the scaling harness
    and the figures) import on their own, loading no JAX."""
    code, err = import_alone(module)
    assert code == 0, err


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
    its library: the port compiles its own ``native/lz4.cpp`` and
    ``native/arith.cpp`` into the repository's build directory, and no
    loader of either runs ``make``."""
    _assert_no_match(re.compile(r"\bfvsrn_tpu[/\\]+native|Makefile|"
                                r"libfvsrn_native|[\"']make[\"']"))
    from fvsrn_tpu_torch import arith
    from fvsrn_tpu_torch.utils import native
    from fvsrn_tpu_torch.volume import lz4io
    build = os.path.join(ROOT, "build", "fvsrn_tpu_torch")
    assert native.NATIVE_DIR == os.path.join(PKG, "native")
    assert native.BUILD_DIR == lz4io.BUILD_DIR == build
    assert lz4io.SOURCE == os.path.join(PKG, "native", "lz4.cpp")
    assert arith.SOURCE == os.path.join(PKG, "native", "arith.cpp")
    for path in (lz4io.library_path(), arith.library_path()):
        assert os.path.dirname(path) == build


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
