"""Port parity, the whole screen trainer on the networks of the paper's
sweeps: the port's ``train.main.run`` against the JAX ``run`` in screen
mode through the fused march (loss history rtol 1e-4, final parameters
per leaf within a relative norm error of 1e-4), two epochs of one 16x16
camera at 1/32 (``tests.test_torch_train.ARGS``). CPU only; the JAX
megakernel runs in Pallas interpret mode. Apart from
tests/test_torch_train.py so that under ``--dist loadfile`` the trainer's
cases run on two workers."""
import numpy as np
import pytest
import torch

from fvsrn_tpu.train import main as jmain
from fvsrn_tpu_torch.train import main
from tests.test_torch_train import ARGS, texture_scene
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)


# the networks of the paper's sweeps the trainer's options express (no
# option gives direction input: test_evaluate_screen_engine_matches_jax)
NETWORK_ARGS = {
    "rgbo": ["--outputmode", "rgbo"],
    "rgbo_texture": ["--outputmode", "rgbo"],
    "rgbo_exp": ["--outputmode", "rgbo:exp"],
    "width48": ["--layers", "48:48:48", "--outputmode", "density"],
    "width64": ["--layers", "64:64", "--outputmode", "density"],
    "relu": ["--activation", "ReLU", "--outputmode", "density"],
    "sine3": ["--activation", "Sine:3", "--outputmode", "density"],
    "snake1": ["--activation", "Snake:1", "--outputmode", "density"],
    "sigmoid": ["--activation", "Sigmoid", "--outputmode", "density"],
    "softplus": ["--activation", "Softplus", "--outputmode", "density"],
}


@pytest.mark.parametrize("case", sorted(NETWORK_ARGS))
def test_network_trainer_matches_jax(case, tmp_path):
    """The sweeps' networks train through the fused march (the
    megakernel) as in the JAX package: color outputs (whose head reads no
    TF, also under a texture TF), widths 48 and 64, every activation;
    two epochs of one 16x16 camera, 1/32, against the JAX trainer (loss
    history rtol 1e-4, parameters 1e-4). A sigmoid density head keeps a
    random network's samples contributing."""
    args = list(ARGS) + NETWORK_ARGS[case]
    if case == "rgbo_texture":
        args[0] = texture_scene(tmp_path)
    jopt = vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a for a in args]))
    want = jmain.run(jopt)
    opt = vars(main.init_parser().parse_args(
        [str(tmp_path / "port.npz") if a == "OUT" else a for a in args]
        + ["--device", "cpu"]))
    got = main.run(opt)
    assert want["fused"] and got["fused"]
    assert got["history"][1] < got["history"][0]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    jparams, _ = network_arrays(want["network"])
    for name, p in got["network"].named_parameters():
        rel = (np.linalg.norm(p.detach().numpy() - jparams[name])
               / np.linalg.norm(jparams[name]))
        assert rel <= 1e-4, (name, rel)
