"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports no JAX, so it runs where the GPU is:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not have). Without a card the kernel tests skip; the
checks of what the kernel takes run anywhere.
"""
import math

import numpy as np
import pytest
import torch

from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import fused_mega
from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.train.checkpoints import load_weights

torch.set_num_threads(1)
ATOL = 1e-4       # float32 kernel vs plain: the fused-vs-oracle contract
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))


def random_net(seed=3, activation="SnakeAlt", output_mode="density:direct",
               channels=8, fourier=6, width=32):
    """A 3-hidden-layer SRN with torch Linear-style random weights."""
    rng = np.random.default_rng(seed)
    sizes = [3 + 2 * fourier + channels, width, width, width, 1]
    arrays = {"input.fourier_matrix": rng.normal(0.0, 2 * math.pi,
                                                 (fourier, 3)),
              "latent.static_grid": rng.standard_normal(
                  (channels, 8, 8, 8)) * 0.3}
    layers = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / math.sqrt(n_in)
        arrays[f"layers.{i}.weight"] = rng.uniform(-bound, bound,
                                                   (n_out, n_in))
        arrays[f"layers.{i}.bias"] = rng.uniform(-bound, bound, n_out)
        layers.append({"activation": activation if i < 3 else "None",
                       "activation_param": 2.0})
    arrays["layers.3.bias"] = np.asarray([0.4])   # a visible density
    return srn_from_arrays(arrays, {"layers": layers,
                                    "output_mode": output_mode})


def block_rays(width, device, distance=1.6):
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.5,
                                                distance=distance),
                           width, width, device=device)
    perm, _ = block_ray_permutation(width, width, 16, 16, device=device)
    return (rs.reshape(-1, 3)[perm].contiguous(),
            rd.reshape(-1, 3)[perm].contiguous())


@pytest.mark.parametrize("which", ["random", "flagship"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_kernel_matches_plain(which, early_out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf, npz = dense_scene()
    net = (random_net() if which == "random" else load_weights(npz)).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    args = (rs, rd, net, *BOX, tf.tensor.cuda())
    kw = dict(stepsize=1 / 128, tmax_clip=clip, enable_early_out=early_out,
              return_samples=True)
    before = fused_mega.LAUNCHES
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mega.LAUNCHES == before + 1
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert fused_mega.LAUNCHES == before + 1
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)


@pytest.mark.parametrize("net_kw,tile", [
    (dict(activation="ReLU"), 256), (dict(output_mode="density"), 256),
    (dict(channels=20), 256), (dict(width=16), 256), ({}, 64)])
def test_mega_kernel_rejects_what_it_does_not_take(net_kw, tile):
    rays = torch.zeros(512, 8)
    with pytest.raises(NotImplementedError):
        fused_mega._check_kernel_inputs(random_net(**net_kw), rays, tile)
    fused_mega._check_kernel_inputs(random_net(), rays, 256)
