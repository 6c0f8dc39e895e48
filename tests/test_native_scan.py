"""Native MS scan engine (native/cmsbwt_scan.cpp) + divergence probe +
reference-index cache."""
import numpy as np
import pytest

from cmsbwt_tpu.config import SEPARATOR, Config
from cmsbwt_tpu.engine.heads import extract_heads
from cmsbwt_tpu.engine.ms_host import ms_scan_collection
from cmsbwt_tpu.engine.probe import kmer_absent_fraction
from cmsbwt_tpu.index.host import build_reference_index
from cmsbwt_tpu.io import fasta
from cmsbwt_tpu.io.native import get_scan_lib, ms_scan_native

from helpers import brute_multidoc_bwt


def _mk(rng, nref, ndocs, snp):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(alpha, size=nref)
    docs = []
    for _ in range(ndocs):
        a = ref.copy()
        k = max(1, int(nref * snp))
        idx = rng.choice(nref, k, replace=False)
        a[idx] = rng.choice(alpha, size=k)
        docs.append(a)
    sx = np.concatenate(
        [np.concatenate([d, np.array([SEPARATOR], np.uint8)])
         for d in docs])
    seps = np.nonzero(sx == SEPARATOR)[0].astype(np.int64)
    return ref, sx, seps


@pytest.mark.parametrize("nref,ndocs,snp", [
    (4000, 3, 0.01), (15000, 4, 0.001), (2000, 5, 0.08),
])
def test_native_scan_matches_host_spec(nref, ndocs, snp):
    if get_scan_lib() is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(nref + ndocs)
    ref, sx, seps = _mk(rng, nref, ndocs, snp)
    x_aug = fasta.augment_reference(ref.tobytes())
    index = build_reference_index(x_aug)
    heads = extract_heads(index, ms_scan_collection(index, sx, seps), sx)
    t, pos, ln, sml = ms_scan_native(
        index.x_padded, index.sa, index.isa, index.lcp, index.plcp,
        index.n, sx, seps)
    assert np.array_equal(t, heads.t)
    assert np.array_equal(pos, heads.pos)
    assert np.array_equal(ln, heads.length)
    assert np.array_equal(sml, heads.smaller)


def test_native_backend_end_to_end(tmp_path):
    """backend='native' through compute_bwt matches the brute-force BWT,
    twice (second run exercises the index cache)."""
    from cmsbwt_tpu.engine.pipeline import compute_bwt
    rng = np.random.default_rng(11)
    ref, sx, seps = _mk(rng, 6000, 3, 0.002)
    (tmp_path / "ref.fa").write_bytes(b">r\n" + ref.tobytes() + b"\n")
    docs = np.split(sx, seps[:-1] + 1)
    with open(tmp_path / "coll.fa", "wb") as f:
        for i, d in enumerate(docs):
            f.write(b">d%d\n" % i + d[:-1].tobytes() + b"\n")
    lst = tmp_path / "in.txt"
    lst.write_text(f"{tmp_path}/ref.fa\n{tmp_path}/coll.fa\n")
    coll = fasta.parse_collection(str(tmp_path / "coll.fa"), 1 << 62)
    expect = brute_multidoc_bwt(coll.sx)
    for run in range(2):
        cfg = Config(filename=str(lst), outname=str(tmp_path / "out"),
                     backend="native",
                     index_cache_dir=str(tmp_path / "idxcache"))
        compute_bwt(cfg)
        got = (tmp_path / "out.bwt").read_bytes()
        assert got == expect, f"run {run}"
    # the cache was actually written
    assert any((tmp_path / "idxcache").iterdir())


def test_probe_separates_regimes():
    rng = np.random.default_rng(3)
    ref, sx_low, _ = _mk(rng, 30000, 2, 0.001)
    x_aug = fasta.augment_reference(ref.tobytes())
    low = kmer_absent_fraction(x_aug, sx_low)
    _, sx_high, _ = _mk(rng, 30000, 2, 0.02)
    high = kmer_absent_fraction(x_aug, sx_high)
    assert low is not None and high is not None
    assert low < 0.10 < high


def test_auto_routes_by_divergence(monkeypatch):
    from cmsbwt_tpu.engine import pipeline as pl
    if get_scan_lib() is None:
        pytest.skip("no native toolchain")
    monkeypatch.setattr(pl, "_on_accelerator", lambda: True)
    rng = np.random.default_rng(4)
    ref, sx_low, _ = _mk(rng, 30000, 2, 0.001)
    x_aug = fasta.augment_reference(ref.tobytes())
    cfg = Config()
    import jax
    accel_devices = [type("D", (), {"platform": "gpu"})()]
    monkeypatch.setattr(jax, "devices", lambda *a: accel_devices)
    assert pl._resolve_backend("auto", 10_000_000, x_aug=x_aug,
                               sx=sx_low, cfg=cfg) == "native"
    # above the measured native/dense crossover (~5-6% SNP) -> dense
    _, sx_high, _ = _mk(rng, 30000, 2, 0.08)
    assert pl._resolve_backend("auto", 10_000_000, x_aug=x_aug,
                               sx=sx_high, cfg=cfg) == "dense"


def test_native_backend_chars_absent_from_reference(tmp_path):
    """Non-ACGT collection bytes (alphabet augmentation) through the
    native C++ engine — byte-equal to the brute-force oracle."""
    from cmsbwt_tpu.engine.pipeline import compute_bwt
    if get_scan_lib() is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(17)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=150)
    (tmp_path / "ref.fa").write_bytes(b">r\n" + ref.tobytes() + b"\n")
    (tmp_path / "coll.fa").write_bytes(
        b">d0\nACGTNNNNACGT\n>d1\nNNXYZWWQNN\n")
    lst = tmp_path / "in.txt"
    lst.write_text(f"{tmp_path}/ref.fa\n{tmp_path}/coll.fa\n")
    cfg = Config(filename=str(lst), outname=str(tmp_path / "o"),
                 backend="native", index_cache_dir="")
    compute_bwt(cfg)
    coll = fasta.parse_collection(str(tmp_path / "coll.fa"), 1 << 62)
    assert (tmp_path / "o.bwt").read_bytes() == brute_multidoc_bwt(coll.sx)
