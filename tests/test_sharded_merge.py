"""Sharded downstream merge (parallel/sharded_merge.py) vs the
single-device merge engine, on the virtual 8-device CPU mesh — the
distributed all-to-all merge."""
import numpy as np
import pytest

from cmsbwt_tpu.engine import device_merge as DM
from cmsbwt_tpu.io import fasta
from cmsbwt_tpu.io.fasta import augment_reference
from cmsbwt_tpu.ops.ms_dense import ms_dense_heads
from cmsbwt_tpu.parallel.sharded_merge import merge_heads_sharded

from helpers import make_fasta, mutate, random_dna


def _case(tmp_path, seed, ref_len, nd, snp, rle_quirk, dup=False,
          n_devices=8):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, ref_len)
    docs = [mutate(rng, ref, snp) for _ in range(nd)]
    if dup:
        docs += [docs[0], docs[0]]  # exact duplicates (counterBad path)
    x_aug = augment_reference(ref)
    cp = tmp_path / "coll.fa"
    cp.write_bytes(make_fasta(docs))
    coll = fasta.parse_collection(str(cp), 2**64 - 1)
    dres = ms_dense_heads(x_aug, coll.sx)
    n = len(x_aug)
    d = coll.d
    # oracle: single-device merge
    rl0, rc0, _ = DM.merge_heads_numpy(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, n, dres.sn, d, rle_quirk)
    # sharded merge
    rl1, rc1 = merge_heads_sharded(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, n, dres.sn, d, rle_quirk, n_devices=n_devices)

    def expand(rl, rc):
        return np.repeat(rc.astype(np.uint8), rl)

    np.testing.assert_array_equal(expand(rl1, rc1), expand(rl0, rc0))
    if rle_quirk:
        # the RLE writer consumes run boundaries — they must match exactly
        np.testing.assert_array_equal(rl1, rl0)
        np.testing.assert_array_equal(rc1, rc0)


@pytest.mark.parametrize("seed,ref_len,nd,snp,rq", [
    (0, 400, 3, 0.03, False),
    (1, 700, 5, 0.01, True),
    (2, 300, 4, 0.1, False),
])
def test_sharded_merge_matches_device_merge(tmp_path, seed, ref_len, nd,
                                            snp, rq):
    _case(tmp_path, seed, ref_len, nd, snp, rq)


def test_sharded_merge_duplicate_docs_counterbad(tmp_path):
    _case(tmp_path, 7, 500, 3, 0.02, True, dup=True)


def test_sharded_merge_single_doc(tmp_path):
    _case(tmp_path, 9, 250, 1, 0.05, False)


@pytest.mark.parametrize("rle", [False, True])
def test_pipeline_merge_backend_sharded(tmp_path, rle):
    """compute_bwt(merge_backend='sharded') is byte-equal to the host
    merge end to end (dense scan feeding the mesh sample-sort merge)."""
    from cmsbwt_tpu.config import Config
    from cmsbwt_tpu.engine.pipeline import compute_bwt

    rng = np.random.default_rng(11)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.02) for _ in range(4)]
    (tmp_path / "ref.fa").write_bytes(b">r\n" + ref + b"\n")
    (tmp_path / "coll.fa").write_bytes(make_fasta(docs))
    (tmp_path / "in.txt").write_text(
        f"{tmp_path / 'ref.fa'}\n{tmp_path / 'coll.fa'}\n")

    outs = {}
    for mb in ("sharded", "host"):
        out = compute_bwt(Config(
            filename=str(tmp_path / "in.txt"), rle=rle,
            outname=str(tmp_path / f"out_{mb}"),
            backend="dense", merge_backend=mb))
        outs[mb] = open(out["out_path"], "rb").read()
    assert outs["sharded"] == outs["host"]


@pytest.mark.parametrize("seed,rq", [(10, False), (11, True)])
def test_sharded_merge_single_device_fast_path(tmp_path, seed, rq):
    """n_devices=1 exercises the degenerate local fast paths in
    parallel/dist.py (the layout the real single-chip bench runs)."""
    _case(tmp_path, seed, 500, 4, 0.02, rq, n_devices=1)


def test_prewarm_lowers_the_dispatched_programs(tmp_path, monkeypatch):
    """The stage programs the prewarm compiles ahead are the ones the merge
    dispatches: same lowering, so the dispatch loads the prewarmed
    executable from the persistent cache instead of compiling again."""
    import jax
    from cmsbwt_tpu.parallel import sharded_merge as SM
    from cmsbwt_tpu.utils import prewarm
    monkeypatch.setenv("CMSBWT_PREWARM", "1")
    monkeypatch.setattr(prewarm, "_seen", set())
    calls = {}

    class Spy:
        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *a, **kw):
            calls.setdefault((self.name, "dispatch"), (a, kw))
            return self.fn(*a, **kw)

        def lower(self, *a, **kw):
            calls.setdefault((self.name, "prewarm"), (a, kw))
            return self.fn.lower(*a, **kw)

    for name in ("_stage_a_program", "_stage_runs"):
        monkeypatch.setattr(SM, name, Spy(name, getattr(SM, name)))
    _case(tmp_path, 3, 300, 4, 0.03, False, n_devices=4)
    with jax.enable_x64(True):
        for name in ("_stage_a_program", "_stage_runs"):
            fn = getattr(SM, name).fn
            texts = [fn.lower(*a, **kw).as_text() for a, kw in
                     (calls[(name, k)] for k in ("prewarm", "dispatch"))]
            assert texts[0] == texts[1], name
