"""Collection-size (sn) capacity routing: the reference's sn is uint64
(ref CMS-BWT.h:26,46), but our device scans/merge are int32-keyed. At/above
the bound, compute_bwt must route through the int64-safe path (blocked
dense scan + host merge) — never silently truncate. Exercised at toy scale
via the CMSBWT_SN_BOUND override."""
import numpy as np
import pytest

from cmsbwt_tpu.config import Config
from cmsbwt_tpu.engine.device_merge import merge_heads_numpy
from cmsbwt_tpu.engine.pipeline import compute_bwt

from helpers import make_inputs, mutate, random_dna


def _toy(tmp_path, seed=21, nd=4):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 800)
    docs = [mutate(rng, ref, 0.02) for _ in range(nd)]
    return make_inputs(tmp_path, ref, docs)


@pytest.mark.parametrize("rle", [False, True])
def test_sn_bound_route_byte_equal(tmp_path, monkeypatch, rle):
    lst, _, _ = _toy(tmp_path)

    cfg = Config(filename=str(lst), outname=str(tmp_path / "a"), rle=rle)
    normal = open(compute_bwt(cfg)["out_path"], "rb").read()

    # force every backend over the bound: auto must reroute to the blocked
    # dense scan + host merge and still produce identical bytes
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    for backend in ("auto", "dense"):
        cfg2 = Config(filename=str(lst), outname=str(tmp_path / backend),
                      rle=rle, backend=backend)
        assert open(compute_bwt(cfg2)["out_path"], "rb").read() == normal


def test_sn_bound_rejects_int32_paths(tmp_path, monkeypatch):
    lst, _, _ = _toy(tmp_path, seed=22)
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    for backend in ("jump", "device"):
        cfg = Config(filename=str(lst), outname=str(tmp_path / "x"),
                     backend=backend)
        with pytest.raises(ValueError, match="int32"):
            compute_bwt(cfg)
    cfg = Config(filename=str(lst), outname=str(tmp_path / "y"),
                 merge_backend="device")
    with pytest.raises(ValueError, match="int32"):
        compute_bwt(cfg)


def test_merge_heads_numpy_hard_guard(monkeypatch):
    monkeypatch.setenv("CMSBWT_SN_BOUND", "100")
    z32 = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="int32"):
        merge_heads_numpy(z32, z32, z32, np.zeros(1, bool),
                          np.zeros(1, np.uint8), z32, z32,
                          np.zeros(1, np.uint8), h=1, n=1, sn=200, d=1,
                          rle_quirk=False)
