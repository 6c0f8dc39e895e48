"""Giant-reference route: above the int32 index bound, compute_bwt builds
its index through the sharded int64 pipeline (parallel/sharded_index.py,
docs/giant_references.md item 4). Exercised at toy scale via the
CMSBWT_GIANT_THRESHOLD override, on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

from cmsbwt_tpu.config import Config
from cmsbwt_tpu.engine.pipeline import compute_bwt
from cmsbwt_tpu.index.host import build_reference_index
from cmsbwt_tpu.io.fasta import augment_reference
from cmsbwt_tpu.parallel.sharded_index import build_sharded_reference_index

from helpers import make_inputs, mutate, random_dna


def test_sharded_index_matches_host_builder():
    rng = np.random.default_rng(11)
    x_aug = augment_reference(random_dna(rng, 700))
    idx = build_sharded_reference_index(x_aug)
    ref = build_reference_index(x_aug)
    assert idx.sa.dtype == np.int64 and idx.isa.dtype == np.int64
    np.testing.assert_array_equal(idx.sa, ref.sa)
    np.testing.assert_array_equal(idx.isa, ref.isa)
    np.testing.assert_array_equal(idx.lcp, ref.lcp)
    np.testing.assert_array_equal(idx.plcp, ref.plcp)
    np.testing.assert_array_equal(idx.bwt, ref.bwt)


@pytest.mark.parametrize("rle", [False, True])
def test_giant_route_byte_equal(tmp_path, monkeypatch, rle):
    rng = np.random.default_rng(12)
    ref = random_dna(rng, 900)
    docs = [mutate(rng, ref, 0.02) for _ in range(4)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)

    cfg = Config(filename=str(lst), outname=str(tmp_path / "a"), rle=rle)
    normal = open(compute_bwt(cfg)["out_path"], "rb").read()

    monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "500")
    cfg2 = Config(filename=str(lst), outname=str(tmp_path / "b"), rle=rle)
    giant = open(compute_bwt(cfg2)["out_path"], "rb").read()
    assert giant == normal


def test_giant_route_rejects_int32_backends(tmp_path, monkeypatch):
    rng = np.random.default_rng(13)
    ref = random_dna(rng, 600)
    lst, _, _ = make_inputs(tmp_path, ref, [mutate(rng, ref, 0.02)])
    monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "500")
    cfg = Config(filename=str(lst), outname=str(tmp_path / "c"),
                 backend="dense")
    with pytest.raises(ValueError, match="int32"):
        compute_bwt(cfg)


def test_giant_route_uses_native_engine(tmp_path, monkeypatch):
    """The >2^31 route runs the native int64 scan engine, not the numpy
    spec loop."""
    from cmsbwt_tpu.io.native import get_scan_lib
    if get_scan_lib() is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(14)
    ref = random_dna(rng, 900)
    docs = [mutate(rng, ref, 0.01) for _ in range(3)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    monkeypatch.setenv("CMSBWT_GIANT_THRESHOLD", "500")
    cfg = Config(filename=str(lst), outname=str(tmp_path / "g"))
    out = compute_bwt(cfg)
    assert out["backend"] == "native"
