"""Port parity, the TPU measurement probes: the plain versions of the port's
probe kernels (``fvsrn_tpu_torch/ops/probes.py``) against the JAX tools'
Pallas kernels (``tools/proto_mega.py``, ``tools/probe_lane_gather.py``)
run in interpret mode on the same inputs, and the port's tools against
their copies of the JAX tools' NumPy oracles. The JAX tools run as they
are, with ``pl.pallas_call`` wrapped to add ``interpret=True`` and keep
the call, and with N and ITERS cut. The CUDA kernels are held against
these plain versions on the card by tests/test_torch_kernels.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_lane_gather as jgather
import tools.proto_mega as jproto
from fvsrn_tpu_torch.ops import probes
from fvsrn_tpu_torch.tools import probe_lane_gather, proto_mega

torch.set_num_threads(1)
N_SMALL = 256


@pytest.fixture
def pallas_calls(monkeypatch):
    """Every ``pl.pallas_call`` the JAX tools build, in interpret mode."""
    calls = []
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = real(*args, **dict(kwargs, interpret=True))
        calls.append(call)
        return call

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jgather, "N", N_SMALL)
    monkeypatch.setattr(jgather, "ITERS", 8)
    return calls


def test_proto_mega_plain_matches_jax_kernel(pallas_calls, capsys):
    jproto.main()
    assert "PROTO OK" in capsys.readouterr().out
    rays, tab = proto_mega.make_inputs()
    want_out, want_cnt = (np.asarray(a) for a in pallas_calls[0](rays, tab))
    out, cnt = probes.proto_mega(torch.from_numpy(rays),
                                 torch.from_numpy(tab), proto_mega.S)
    np.testing.assert_allclose(out.numpy(), want_out,
                               atol=1e-5 * np.abs(want_out).max())
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    err1, err2 = proto_mega.errors(out.numpy(), cnt.numpy(),
                                   *proto_mega.reference(rays, tab))
    assert err1 < 1e-5 and err2 == 0.0


GATHERS = {
    "single_f32": (functools.partial(jgather.probe_gather_single,
                                     jnp.float32), 128, torch.float32,
                   probes.gather_single),
    "single_bf16": (functools.partial(jgather.probe_gather_single,
                                      jnp.bfloat16), 128, torch.bfloat16,
                    probes.gather_single),
    "chunked_928": (functools.partial(jgather.probe_gather_chunked, 928,
                                      jnp.float32), 928, torch.float32,
                    probes.gather_chunked),
}


@pytest.mark.parametrize("case", sorted(GATHERS))
def test_gather_plain_matches_jax_kernel(case, pallas_calls):
    jfn, k, dtype, port = GATHERS[case]
    ok, _ = jfn()
    assert ok
    tab = np.random.default_rng(0).standard_normal((128, k)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, k, (128, N_SMALL)).astype(
        np.int32)
    jtab = jnp.asarray(tab).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
    want = np.asarray(pallas_calls[0](jtab, jnp.asarray(idx)))
    got = port(torch.from_numpy(tab).to(dtype), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sz3p", [128, 928])
def test_onehot_plain_matches_jax_kernel(sz3p, pallas_calls):
    ok, _ = jgather.probe_onehot(sz3p, jnp.bfloat16)
    assert ok
    tab = np.random.default_rng(0).standard_normal((sz3p, 128)).astype(
        np.float32)
    lrow = np.random.default_rng(1).integers(0, sz3p, (1, N_SMALL)).astype(
        np.int32)
    want = np.asarray(pallas_calls[0](jnp.asarray(tab).astype(jnp.bfloat16),
                                      jnp.asarray(lrow)))
    got = probes.onehot_resolve(torch.from_numpy(tab).to(torch.bfloat16),
                                torch.from_numpy(lrow))
    assert got.shape == (128, N_SMALL) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_indices_give_zero():
    """The chunked gather's masked select and the one-hot's empty column:
    an index outside the table reads 0."""
    tab = torch.arange(2 * 300, dtype=torch.float32).reshape(2, 300) + 1.0
    idx = torch.tensor([[0, -1, 299, 300], [5, 1000, -7, 17]],
                       dtype=torch.int32)
    got = probes.gather_chunked(tab, idx)
    assert got.tolist() == [[1.0, 0.0, 300.0, 0.0], [306.0, 0.0, 0.0, 318.0]]
    small = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    rows = torch.tensor([[2, -1, 3, 0]], dtype=torch.int32)
    res = probes.onehot_resolve(small.to(torch.bfloat16), rows)
    assert res.tolist() == [[5.0, 0.0, 0.0, 1.0], [6.0, 0.0, 0.0, 2.0]]


@pytest.mark.parametrize("probe", range(len(probe_lane_gather.PROBES)))
def test_port_tool_matches_numpy_oracle(probe):
    """The port's tool on the CPU (plain versions) passes its copy of the
    JAX tool's oracle and reports what the JAX tool reports."""
    _, fn = probe_lane_gather.PROBES[probe]
    res = fn("cpu", n=N_SMALL, iters=1)
    assert res["ok"] and res["max_abs_err"] == 0.0
    assert res["us"] > 0 and res["bytes"] > N_SMALL * 128 * 4


def test_port_tools_print_what_the_jax_tools_print(capsys, monkeypatch):
    monkeypatch.setattr(probe_lane_gather, "N", N_SMALL)
    monkeypatch.setattr(probe_lane_gather, "ITERS", 1)
    monkeypatch.setattr(proto_mega, "ITERS", 1)
    assert proto_mega.main(["--device", "cpu"]) == 0
    assert probe_lane_gather.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PROTO OK" in out and "out rel err:" in out
    for name in ("gather single f32", "gather single bf16",
                 "gather chunked 928 f32", "onehot 128 bf16",
                 "onehot 928 bf16"):
        assert f"{name}: ok=True" in out and "ns/sample" in out


def test_wrappers_count_only_kernel_launches():
    probes.reset_counts()
    probes.gather_single(torch.zeros(2, 4), torch.zeros(2, 4,
                                                        dtype=torch.int32))
    assert probes.counts() == {"proto_mega": 0, "gather_single": 0,
                               "gather_chunked": 0, "onehot_resolve": 0}
