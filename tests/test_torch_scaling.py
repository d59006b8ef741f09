"""Port parity, the scaling harness (``fvsrn_tpu_torch/eval/eval_scaling.py``
against ``fvsrn_tpu/eval/eval_scaling.py``), on the CPU: the render of
``measure``'s scene sharded over two ``gloo`` ranks equals the one-rank
render, and that render is within 1e-5 of the JAX package's ``trace_dvr``
of its own scene (JAX's network at its widths, seed 1) at 32x32, stepsize
1/64; ``main``'s last line parses to the JAX harness's schema, with and
without ``--spawn``, and its default device raises without a card."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.eval import eval_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
H = 1 / 64
TOL = 1e-5


def jax_render():
    """The JAX harness's scene (eval_scaling.measure), traced whole."""
    rng = np.random.default_rng(0)
    latent = JLatent(static_grid=(
        rng.standard_normal((8, 16, 16, 16)) * 0.05).astype(np.float32))
    net = JSRN.make(layers="32:32", activation="SnakeAlt:2", num_fourier=8,
                    output_mode="density:direct", latent=latent, seed=1)
    tf = JTF.make(rgb=[[0.9, 0.3, 0.1], [1.0, 1.0, 0.7]],
                  opacity=[0.0, 20.0], positions=[0.0, 1.0])
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.5, distance=1.6),
                            SIZE, SIZE)
    return np.asarray(jtrace_dvr(
        jnp.reshape(rs, (-1, 3)), jnp.reshape(rd, (-1, 3)),
        JVolume.make(net), tf, JCfg.make(stepsize=H, enable_early_out=False),
        max_steps_bound((1.0, 1.0, 1.0), H)).color)


@pytest.fixture(scope="module")
def renders():
    """(one-rank, two-rank) colors and rays/s of measure's scene."""
    return {n: eval_scaling.run_trials(n, SIZE, SIZE, H, repeats=1,
                                       device="cpu")
            for n in (1, 2)}


def test_two_ranks_equal_one(renders):
    (r1, img1), (r2, img2) = renders[1], renders[2]
    assert img1.shape == img2.shape == (SIZE * SIZE, 4)
    np.testing.assert_array_equal(img2.numpy(), img1.numpy())
    assert r1[0] > 0 and r2[0] > 0


def test_render_matches_jax(renders):
    want = jax_render()
    got = renders[2][1].numpy()
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_main_prints_jax_schema(capsys):
    assert eval_scaling.main(["--device", "cpu", "--devices", "1", "2",
                              "--width", "16", "--height", "16",
                              "--trials", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["1", "2"]
    for n, r in out.items():
        assert set(r) == {"rays_per_s", "efficiency_vs_linear",
                          "rays_per_s_std"}
        assert r["rays_per_s"] > 0
    assert out["1"]["efficiency_vs_linear"] == 1.0
    assert not eval_scaling.shared_device(2, "cpu")


def test_cuda_is_asked_for_not_guessed():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_scaling.main(["--devices", "1"])


def test_spawn_prints_jax_schema():
    """``--spawn``: one pinned subprocess a rank count (``taskset``), its
    last line read back; JAX's schema and linear efficiency at one rank."""
    proc = subprocess.run(
        [sys.executable, "-m", "fvsrn_tpu_torch.eval.eval_scaling",
         "--spawn", "--device", "cpu", "--devices", "1", "--width", "16",
         "--height", "16"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["1"]
    assert set(out["1"]) == {"rays_per_s", "efficiency_vs_linear"}
    assert out["1"]["efficiency_vs_linear"] == 1.0
