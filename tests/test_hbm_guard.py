"""HBM-aware auto-blocking (pipeline dense branch) and bench env-override
propagation (the r03 lesson: parent-side config mutation never reached the
subprocess children)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_bench_env_overrides_apply_in_child(monkeypatch):
    import importlib

    import bench
    importlib.reload(bench)
    monkeypatch.setenv("BENCH_REF_MBP", "0.25")
    monkeypatch.setenv("BENCH_DOCS", "3")
    names = bench.apply_env_overrides()
    assert names == ["primary"]
    assert bench.CONFIGS["primary"]["ref_mbp"] == 0.25
    assert bench.CONFIGS["primary"]["docs"] == 3


def test_bench_full_overrides(monkeypatch):
    import importlib

    import bench
    importlib.reload(bench)
    monkeypatch.setenv("BENCH_FULL", "1")
    bench.apply_env_overrides()
    assert bench.CONFIGS["ecoli_rle"]["docs"] == 100


def test_hbm_guard_blocks_oversized_scan(tmp_path, monkeypatch):
    """A tiny CMSBWT_HBM_GB budget must force the dense path into blocks
    (and stay byte-identical to the unblocked run)."""
    from cmsbwt_tpu.config import Config
    from cmsbwt_tpu.engine.pipeline import compute_bwt
    from cmsbwt_tpu.ops import ms_dense

    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(alpha, size=3000)
    doc = ref.copy()
    doc[rng.choice(3000, 30, replace=False)] = alpha[0]
    (tmp_path / "ref.fa").write_bytes(b">r\n" + ref.tobytes() + b"\n")
    (tmp_path / "coll.fa").write_bytes(b">d\n" + doc.tobytes() + b"\n")
    lst = tmp_path / "in.txt"
    lst.write_text(f"{tmp_path}/ref.fa\n{tmp_path}/coll.fa\n")

    calls = {}
    orig = ms_dense.ms_dense_heads_blocked

    def spy(*a, **kw):
        calls["block_chars"] = kw.get("block_chars") or a[2]
        return orig(*a, **kw)

    monkeypatch.setattr(ms_dense, "ms_dense_heads_blocked", spy)
    monkeypatch.setenv("CMSBWT_HBM_GB", "0.000001")  # ~1 KB budget
    cfg = Config(filename=str(lst), outname=str(tmp_path / "a"),
                 backend="dense", merge_backend="host")
    compute_bwt(cfg)
    assert calls, "HBM guard did not route through the blocked scan"

    monkeypatch.delenv("CMSBWT_HBM_GB")
    cfg2 = Config(filename=str(lst), outname=str(tmp_path / "b"),
                  backend="dense", merge_backend="host")
    compute_bwt(cfg2)
    assert (tmp_path / "a.bwt").read_bytes() == \
        (tmp_path / "b.bwt").read_bytes()


class _FakeDevice:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, env, want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, None,
     0.85 * (60 << 30)),
    ({"bytes_limit": 60 << 30, "bytes_in_use": 10 << 30}, None,
     0.85 * (50 << 30)),
    ({"bytes_limit": 60 << 30}, "2", float(2 << 30)),
    (None, "2", float(2 << 30)),
    (None, None, None),
    ({"bytes_in_use": 0}, None, None),
])
def test_memory_budget_from_device(monkeypatch, stats, env, want):
    """The guard's budget is a share of the device's free bytes
    (bytes_limit less bytes_in_use) unless CMSBWT_HBM_GB overrides it; a
    device that reports no limit gives no budget."""
    import jax
    from cmsbwt_tpu.engine import pipeline as pl
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])
    if env is None:
        monkeypatch.delenv("CMSBWT_HBM_GB", raising=False)
    else:
        monkeypatch.setenv("CMSBWT_HBM_GB", env)
    assert pl._device_memory_budget() == want


def test_guard_block_size():
    """No budget or a budget that holds the joint string: unblocked.
    Over the budget: blocks of at least 8 Mi symbols, larger for a larger
    budget."""
    from cmsbwt_tpu.engine import pipeline as pl
    n, sn = 5_000_000, 100_000_000
    per = pl.BYTES_PER_SYMBOL
    assert pl._guard_block_chars(n, sn, None) is None
    assert pl._guard_block_chars(n, sn, 10.0 * per * (n + sn)) is None
    small = pl._guard_block_chars(n, sn, 1.0)
    assert small == 8 << 20
    mid = pl._guard_block_chars(n, sn, 0.5 * per * (n + sn))
    assert 8 << 20 < mid < sn


def test_cpu_backend_forces_no_blocking(monkeypatch):
    """On the CPU backend (no bytes_limit) the dense scan runs unblocked
    however large the input looks."""
    from cmsbwt_tpu.engine import pipeline as pl
    monkeypatch.delenv("CMSBWT_HBM_GB", raising=False)
    assert pl._device_memory_budget() is None
    assert pl._guard_block_chars(1 << 30, 1 << 32,
                                 pl._device_memory_budget()) is None
