"""Aux subsystems: checkpoint/resume, CLI, timers, logging."""
import json
import subprocess
import sys

import numpy as np

from cmsbwt_tpu.config import Config
from cmsbwt_tpu.engine.pipeline import compute_bwt
from cmsbwt_tpu.utils.checkpoint import CheckpointManager
from cmsbwt_tpu.utils.timing import PhaseTimer

from helpers import make_inputs, mutate, random_dna


def test_checkpoint_roundtrip(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"))
    fp = ck.fingerprint(a=1, b="x")
    arrays = {"x": np.arange(5), "y": np.ones(3, np.uint8)}
    ck.save("phase1", fp, arrays)
    got = ck.load("phase1", fp)
    np.testing.assert_array_equal(got["x"], arrays["x"])
    # stale fingerprint rejected
    assert ck.load("phase1", ck.fingerprint(a=2)) is None
    # missing
    assert ck.load("nope", fp) is None


def _ckpt_writer(ckdir, q):
    try:
        ck = CheckpointManager(ckdir)
        fp = ck.fingerprint(k="same")
        rng = np.random.default_rng(0)  # same content in every writer
        arrays = {"x": rng.integers(0, 255, 200_000, dtype=np.uint8)}
        for _ in range(20):
            ck.save("slot", fp, arrays)
            got = ck.load("slot", fp)
            assert got is not None and got["x"].shape == (200_000,)
        q.put(None)
    except Exception as e:  # pragma: no cover
        q.put(repr(e))


def test_checkpoint_concurrent_writers(tmp_path):
    """Concurrent processes saving the same slot must not crash
    (a shared fixed tmp path raced under -n auto)."""
    import multiprocessing as mp
    import os

    ckdir = str(tmp_path / "ck")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_ckpt_writer, args=(ckdir, q))
             for _ in range(3)]
    for p in procs:
        p.start()
    errs = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    assert errs == [None, None, None], errs
    leftovers = [f for f in os.listdir(ckdir) if f.endswith(".tmp")]
    assert leftovers == []


def test_checkpoint_distinct_fingerprints_coexist(tmp_path):
    """Different inputs must occupy different cache slots (no thrash)."""
    ck = CheckpointManager(str(tmp_path / "ck"))
    fp1, fp2 = ck.fingerprint(a=1), ck.fingerprint(a=2)
    ck.save("ref_index", fp1, {"x": np.arange(3)})
    ck.save("ref_index", fp2, {"x": np.arange(5)})
    assert ck.load("ref_index", fp1)["x"].shape == (3,)
    assert ck.load("ref_index", fp2)["x"].shape == (5,)


def test_dense_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 300)
    docs = [mutate(rng, ref, 0.02) for _ in range(3)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    ckdir = str(tmp_path / "ck")
    cfg = Config(filename=str(lst), outname=str(tmp_path / "a"),
                 backend="dense", checkpoint_dir=ckdir)
    a = compute_bwt(cfg)
    # resume: second run must reuse the checkpoint and agree byte-for-byte
    cfg2 = Config(filename=str(lst), outname=str(tmp_path / "b"),
                  backend="dense", checkpoint_dir=ckdir)
    b = compute_bwt(cfg2)
    assert (tmp_path / "a.bwt").read_bytes() == (tmp_path / "b.bwt").read_bytes()
    assert list((tmp_path / "ck").glob("dense_heads.*.npz"))


def test_cli_end_to_end(tmp_path):
    rng = np.random.default_rng(1)
    ref = random_dna(rng, 200)
    docs = [mutate(rng, ref, 0.02) for _ in range(2)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    out = tmp_path / "cliout"
    r = subprocess.run(
        [sys.executable, "-m", "cmsbwt_tpu", "-o", str(out), str(lst)],
        capture_output=True, text=True,
        cwd=str(tmp_path.parent),
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH":
             str(__import__("pathlib").Path(__file__).parents[1]),
             "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "cliout.bwt").exists()
    assert (tmp_path / "cliout.log").exists()


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.get("a") >= 0
    assert "a:" in t.report() and "total:" in t.report()


def test_auto_backend_resolution():
    # explicit choices pass through untouched; auto prefers the native
    # PLCP-skip engine whenever the toolchain built it (small inputs and
    # every CPU-only size), falling back to host/jump without it
    from cmsbwt_tpu.engine.pipeline import (AUTO_DENSE_MIN_CHARS,
                                            _resolve_backend)
    from cmsbwt_tpu.io.native import get_scan_lib
    native = get_scan_lib() is not None
    assert _resolve_backend("dense", 10) == "dense"
    assert _resolve_backend("host", 10**9) == "host"
    assert _resolve_backend("auto", AUTO_DENSE_MIN_CHARS - 1) == \
        ("native" if native else "host")
    assert _resolve_backend("auto", 10**9) == \
        ("native" if native else "jump")
    assert _resolve_backend("auto", None) == \
        ("native" if native else "jump")
