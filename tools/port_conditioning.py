"""The CPU figures behind the tolerances of the networks' parity tests
and of fault F6, on the tests' own setups (CPU; imports the JAX package
and the port, as the tests do):

- Sine:30 on tests/test_torch_mega_networks.py's 16x16 view: the JAX
  megakernel and the port's plain version against JAX's float32 lattice
  oracle (float32 table, no tile vote), max |d|;
- how far one ulp (a relative 1e-7, three seeds) of weight noise moves
  the plain version's Sine:30 image on that view and on
  tests/test_torch_kernels.py's 64x64 card case, and its gradient leaves
  (relative norm) on the 16x16 view;
- fault F6 on tests/test_torch_train.py's 16x48^3 case: the JAX plain
  loss, the port's by its gate's route (the plain march) and by the
  parent's (the fused megakernel).

    JAX_PLATFORMS=cpu python tools/port_conditioning.py
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import test_torch_kernels as tk  # noqa: E402
import test_torch_mega_networks as tn  # noqa: E402
import test_torch_train as tt  # noqa: E402
from fvsrn_tpu_torch.convert import srn_from_arrays  # noqa: E402
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain  # noqa: E402
from fvsrn_tpu_torch.scenes import dense_scene  # noqa: E402
from tools.export_torch_weights import network_arrays  # noqa: E402

EPS = 1e-7
SEEDS = (1, 2, 3)


def noisy_arrays(arrays, seed):
    rng = np.random.default_rng(seed)
    return {k: (v * (1.0 + EPS * rng.standard_normal(v.shape))).astype(
        np.float32) for k, v in arrays.items()}


def sine30_view():
    jnet = tn.jax_net("sine30")
    rs, rd = tn.block_rays()
    tf = tn.JTF.make(**tn.TF).tensor
    oracle = np.asarray(tn.jax_oracle(jnet, rs, rd, tf))
    kernel = np.asarray(tn.jax_mega(jnet, rs, rd, tf,
                                    table_dtype=tn.jnp.float32,
                                    enable_early_out=False))
    kw = dict(stepsize=tn.H, seg=tn.SEG, tile=tn.TILE,
              table_dtype=torch.float32, enable_early_out=False)
    arrays, meta = network_arrays(jnet)

    def plain(arr):
        return mega_trace_dvr_plain(
            torch.tensor(rs), torch.tensor(rd), srn_from_arrays(arr, meta),
            tn.BMIN, tn.BSIZE, torch.tensor(np.asarray(tf)), **kw).numpy()

    base = plain(arrays)
    print(f"Sine:30 16x16: JAX megakernel vs JAX oracle "
          f"{np.abs(kernel - oracle).max():.2e}, port plain vs JAX oracle "
          f"{np.abs(base - oracle).max():.2e}; one ulp of weight noise "
          "moves the plain image by " + ", ".join(
              f"{np.abs(plain(noisy_arrays(arrays, s)) - base).max():.2e}"
              for s in SEEDS))
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    _, _, g0 = tn.port_grads(srn_from_arrays(arrays, meta), rs, rd, w, tf,
                             early_out=False)
    moved = []
    for s in SEEDS:
        _, _, g = tn.port_grads(srn_from_arrays(noisy_arrays(arrays, s),
                                                meta), rs, rd, w, tf,
                                early_out=False)
        moved += [tn.rel(g[k], g0[k]) for k in g0]
    print(f"Sine:30 16x16: the leaves move by {min(moved):.2e} to "
          f"{max(moved):.2e} (relative norm)")


def sine30_card_case():
    rs, rd = tk.block_rays(64, "cpu")
    clip = torch.empty(rs.shape[0]).uniform_(
        1.0, 2.2, generator=torch.Generator().manual_seed(0))
    tf = dense_scene()[1].tensor

    def image(net):
        return mega_trace_dvr_plain(rs, rd, net, *tk.BOX, tf,
                                    stepsize=1 / 128, tmax_clip=clip)

    net = tk.random_net(activation="Sine", act_param=30.0)
    base = image(net)
    moved = []
    for s in SEEDS:
        gen = torch.Generator().manual_seed(s)
        other = tk.random_net(activation="Sine", act_param=30.0)
        with torch.no_grad():
            for p in other.parameters():
                p.mul_(1.0 + EPS * torch.randn(p.shape, generator=gen))
        moved.append(float((image(other) - base).abs().max()))
    print("Sine:30 64x64 card case: one ulp of weight noise moves the plain "
          "image by " + ", ".join(f"{v:.2e}" for v in moved))


def fault_f6():
    jargs, args, _, ds = tt.f4_case(channels=16, res=48)
    (jl, _), (loss, _) = tt.f4_loss_and_grads_plain(jargs, args)
    with torch.no_grad():
        parent, _ = tt.evaluate_screen(*args, use_fused=True,
                                       fused_kwargs=tt.screen_mega_kwargs(ds))
    print(f"F6 16x48^3: JAX loss {jl:.7f}; port by the plain march "
          f"{loss:.7f} (rel {abs(loss - jl) / abs(jl):.2e}); by the fused "
          f"megakernel {float(parent):.7f} "
          f"(rel {abs(float(parent) - jl) / abs(jl):.2e})")


if __name__ == "__main__":
    torch.set_num_threads(8)
    sine30_view()
    sine30_card_case()
    fault_f6()
