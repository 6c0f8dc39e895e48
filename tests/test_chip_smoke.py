"""chip_smoke.py: its phases run in-process at toy size on the virtual CPU
mesh, with their comparisons; only ``main`` insists on a GPU."""
import os
import pathlib
import subprocess
import sys

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parent.parent

TOY = {
    "ecoli": dict(ref_mbp=0.02, docs=3, snp=0.01, rle=True),
    "lowdiv": dict(ref_mbp=0.01, docs=3, snp=0.001, rle=False),
    "primary": dict(ref_mbp=0.02, docs=3, snp=0.01, rle=False),
    "lanes": dict(ref_mbp=0.01, docs=2, snp=0.01, rle=False),
    "mesh": dict(ref_mbp=0.01, docs=6, snp=0.01, rle=False),
}


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    if not chip_smoke.REF_BIN.exists():
        pytest.skip("reference binary not built")
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", "")
    with chip_smoke.Smoke(tmp_path, workloads=TOY,
                          block_chars=1 << 14) as s:
        yield s


@pytest.mark.parametrize("phase", list(chip_smoke.ONE_CARD_PHASES)
                         + list(chip_smoke.FOUR_CARD_PHASES))
def test_phase_byte_equal(smoke, phase):
    rec = smoke.run_phase(phase)
    assert rec["byte_equal"], rec
    assert rec["phase"] == phase and rec["sn"] > 0
    assert rec["first_s"] > 0 and rec["warm_s"] > 0
    # the CPU process keeps no persistent compile cache
    assert rec["cache_loads"] == [0, 0]
    assert rec["programs"][0] >= rec["programs_over_1s"][0]


def test_phase_b_runs_blocked_after_a(smoke):
    """B compares with A's output, running A first; the blocked scan is
    what B runs."""
    from cmsbwt_tpu.ops import ms_dense
    calls = []
    real = ms_dense.ms_dense_heads_blocked_on_device

    def spy(*a, **kw):
        calls.append(kw["block_chars"])
        return real(*a, **kw)

    ms_dense.ms_dense_heads_blocked_on_device = spy
    try:
        smoke.run_phase("B")
    finally:
        ms_dense.ms_dense_heads_blocked_on_device = real
    assert [r["phase"] for r in smoke.records] == ["A", "B"]
    assert calls == [1 << 14, 1 << 14]


def test_mismatch_is_reported(smoke, tmp_path):
    """A phase whose output differs from what it is compared with records
    byte_equal=False (main then exits non-zero)."""
    other = tmp_path / "other.bwt"
    other.write_bytes(b"ACGT")
    rec = smoke._measure(
        "F", "lanes", "lane scan",
        lambda out: smoke._run_config("lanes", out, backend="device"),
        lambda: other, "a wrong file")
    assert rec["byte_equal"] is False


def test_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "phase" not in r.stdout
    assert "no GPU" in r.stderr
