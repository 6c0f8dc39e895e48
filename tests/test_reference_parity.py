"""Cross-check against the compiled C++ reference tool (BASELINE.md contract:
byte-identical .bwt / .rl_bwt). The reference is built from the read-only
mount with a local libsais-API shim (baseline/)."""
import pathlib
import subprocess

import numpy as np
import pytest

from cmsbwt_tpu.config import Config
from cmsbwt_tpu.engine.pipeline import compute_bwt

from helpers import make_inputs, mutate, random_dna

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_BIN = REPO / "baseline" / "cms-bwt-ref"


@pytest.fixture(scope="session")
def ref_bin():
    if not REF_BIN.exists():
        r = subprocess.run([str(REPO / "baseline" / "build.sh")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[-500:]}")
    return str(REF_BIN)


def run_both(tmp_path, ref_bin, ref, docs, rle=False, prefix=None, **kw):
    lst, _, _ = make_inputs(tmp_path, ref, docs, **kw)
    args = [ref_bin]
    cfg = Config(filename=str(lst), outname=str(tmp_path / "ours"), rle=rle)
    if rle:
        args.append("-r")
    if prefix is not None:
        args += ["-p", str(prefix)]
        cfg.prefix_length = prefix
    args += ["-o", str(tmp_path / "ref"), str(lst)]
    subprocess.run(args, check=True, capture_output=True)
    compute_bwt(cfg)
    ext = ".rl_bwt" if rle else ".bwt"
    ours = (tmp_path / ("ours" + ext)).read_bytes()
    refs = (tmp_path / ("ref" + ext)).read_bytes()
    return ours, refs


@pytest.mark.parametrize("seed,reflen,ndocs,snp,rle", [
    (0, 400, 4, 0.01, False),
    (0, 400, 4, 0.01, True),
    (1, 1500, 6, 0.002, False),
    (1, 1500, 6, 0.002, True),
    (2, 800, 3, 0.05, True),
])
def test_parity_mutated(tmp_path, ref_bin, seed, reflen, ndocs, snp, rle):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, reflen)
    docs = [mutate(rng, ref, snp) for _ in range(ndocs)]
    ours, refs = run_both(tmp_path, ref_bin, ref, docs, rle=rle)
    assert ours == refs


def test_parity_duplicates_and_n_chars(tmp_path, ref_bin):
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    docs = [d, d, b"ACGTNNNNACGT" + d[:100], d]
    for rle in (False, True):
        ours, refs = run_both(tmp_path, ref_bin, ref, docs, rle=rle)
        assert ours == refs


def test_parity_prefix_flag(tmp_path, ref_bin):
    rng = np.random.default_rng(4)
    ref = random_dna(rng, 500)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    ours, refs = run_both(tmp_path, ref_bin, ref, docs, prefix=700)
    assert ours == refs


def test_parity_indels(tmp_path, ref_bin):
    rng = np.random.default_rng(5)
    ref = random_dna(rng, 1000)
    docs = [mutate(rng, ref, 0.005, indel_rate=0.01) for _ in range(5)]
    for rle in (False, True):
        ours, refs = run_both(tmp_path, ref_bin, ref, docs, rle=rle)
        assert ours == refs


def test_parity_debug_artifact(tmp_path, ref_bin):
    """Small path writes <out>.counterSmallerThanHead_true (ref :919-924)."""
    rng = np.random.default_rng(6)
    ref = random_dna(rng, 400)
    docs = [mutate(rng, ref, 0.02) for _ in range(3)]
    run_both(tmp_path, ref_bin, ref, docs)
    ours = (tmp_path / "ours.counterSmallerThanHead_true").read_bytes()
    refs = (tmp_path / "ref.counterSmallerThanHead_true").read_bytes()
    assert ours == refs


def test_parity_raw_reference_with_dollar(tmp_path, ref_bin):
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 300)
    docs = [mutate(rng, ref, 0.01) for _ in range(2)]
    # raw (non-FASTA) reference file ending in '$\n' exercises trailing strip
    lst, ref_path, _ = make_inputs(tmp_path, ref + b"$\n", docs)
    subprocess.run([ref_bin, "-o", str(tmp_path / "ref"), str(lst)],
                   check=True, capture_output=True)
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "ours")))
    assert (tmp_path / "ours.bwt").read_bytes() == \
        (tmp_path / "ref.bwt").read_bytes()


def test_parity_device_backend(tmp_path, ref_bin):
    """Full device path (index + MS scan on JAX) vs the reference binary."""
    rng = np.random.default_rng(11)
    ref = random_dna(rng, 900)
    docs = [mutate(rng, ref, 0.01) for _ in range(5)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    for rle in (False, True):
        args = [ref_bin] + (["-r"] if rle else []) + \
            ["-o", str(tmp_path / "ref"), str(lst)]
        subprocess.run(args, check=True, capture_output=True)
        cfg = Config(filename=str(lst), outname=str(tmp_path / "ours"),
                     rle=rle, backend="device", lanes=8, skip_window=32)
        compute_bwt(cfg)
        ext = ".rl_bwt" if rle else ".bwt"
        assert (tmp_path / ("ours" + ext)).read_bytes() == \
            (tmp_path / ("ref" + ext)).read_bytes()


def test_parity_dense_backend(tmp_path, ref_bin):
    """Dense (joint suffix sort) backend vs the reference binary."""
    rng = np.random.default_rng(12)
    ref = random_dna(rng, 700)
    docs = [mutate(rng, ref, 0.02) for _ in range(4)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    for rle in (False, True):
        args = [ref_bin] + (["-r"] if rle else []) + \
            ["-o", str(tmp_path / "ref"), str(lst)]
        subprocess.run(args, check=True, capture_output=True)
        cfg = Config(filename=str(lst), outname=str(tmp_path / "ours"),
                     rle=rle, backend="dense")
        compute_bwt(cfg)
        ext = ".rl_bwt" if rle else ".bwt"
        assert (tmp_path / ("ours" + ext)).read_bytes() == \
            (tmp_path / ("ref" + ext)).read_bytes()

