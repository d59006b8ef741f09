"""Port parity, the ensemble volume factory
(``fvsrn_tpu_torch/volume/ensemble.py``): member filenames from the
printf-style template with start and step offsets, the JSON settings
round trip (a factory read from a file resolves against its folder), the
LRU cache's eviction and member loads through the port's ``.cvol``
reader, against the JAX package's factory."""
import numpy as np
import pytest

from fvsrn_tpu.volume.ensemble import LRUCache as JLRUCache
from fvsrn_tpu.volume.ensemble import VolumeEnsembleFactory as JFactory
from fvsrn_tpu_torch.volume.ensemble import LRUCache, VolumeEnsembleFactory
from fvsrn_tpu_torch.volume.volume import Volume

SETTINGS = dict(format_string="vol_e%03d_t%02d.cvol",
                num_ensembles=3, num_timesteps=7, start_ensemble=1,
                step_ensemble=2, start_timestep=2, step_timestep=3)


def test_filenames_match_jax(tmp_path):
    for fmt in ("vol_e%03d_t%02d.cvol", "member%d.cvol", "static.cvol",
                "/abs/e%d_%d_100%%.cvol"):
        kw = dict(SETTINGS, format_string=fmt, root=str(tmp_path))
        fac, jfac = VolumeEnsembleFactory(**kw), JFactory(**kw)
        for e in range(3):
            for t in range(7):
                assert fac.get_volume_filename(e, t) == \
                    jfac.get_volume_filename(e, t)
    fac = VolumeEnsembleFactory(**dict(SETTINGS, root=str(tmp_path)))
    assert fac.get_volume_filename(1, 2).endswith("vol_e003_t08.cvol")
    with pytest.raises(IndexError):
        fac.get_volume_filename(3, 0)
    with pytest.raises(IndexError):
        fac.get_volume_filename(0, 7)


def test_json_round_trip_matches_jax(tmp_path):
    fac = VolumeEnsembleFactory(**dict(SETTINGS,
                                       format_string="e%d_t%d.cvol"))
    fac.save(str(tmp_path / "port.json"))
    JFactory(**dict(SETTINGS, format_string="e%d_t%d.cvol")).save(
        str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    sub = tmp_path / "data"
    sub.mkdir()
    (sub / "fac.json").write_text((tmp_path / "port.json").read_text())
    back = VolumeEnsembleFactory.from_file(str(sub / "fac.json"))
    jback = JFactory.from_file(str(sub / "fac.json"))
    for key in ("format_string", "num_ensembles", "num_timesteps",
                "start_ensemble", "step_ensemble", "start_timestep",
                "step_timestep", "root"):
        assert getattr(back, key) == getattr(jback, key), key
    assert back.root == str(sub)
    assert back.get_volume_filename(2, 6) == str(sub / "e5_t20.cvol")


def test_lru_eviction_matches_jax():
    port_loads, jax_loads = [], []
    cache, jcache = LRUCache(2), JLRUCache(2)
    for k in (1, 2, 1, 3, 2, 2, 1):
        assert cache.get_or_load(k, lambda k: port_loads.append(k) or k * 10
                                 ) == jcache.get_or_load(
            k, lambda k: jax_loads.append(k) or k * 10)
    assert port_loads == jax_loads == [1, 2, 3, 2, 1]
    assert len(cache) == 2


def test_load_members(tmp_path):
    for e in range(2):
        for t in range(2):
            v = Volume()
            v.add_feature("density", np.full((2, 2, 2, 1), e * 10 + t,
                                             np.float32))
            v.save(str(tmp_path / f"vol_e{e:03d}_t{t:02d}.cvol"))
    fac = VolumeEnsembleFactory(format_string="vol_e%03d_t%02d.cvol",
                                num_ensembles=3, num_timesteps=2,
                                root=str(tmp_path))
    v = fac.load_volume(1, 1)
    np.testing.assert_allclose(v.density, 11.0)
    assert fac.load_volume(1, 1) is v
    assert fac.load_volume(2, 0) is None
