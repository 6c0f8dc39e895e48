"""Driver benchmark: end-to-end CMS-BWT on synthetic pangenome data.

Once the GPU probe passes, ALWAYS prints ONE JSON line, even when every
config fails or times out:
  {"metric": ..., "value": N, "unit": "Mchars/s", "vs_baseline": N,
   "platform": ..., "headline_config": ..., "configs": [...]}

value / vs_baseline come from the PRIMARY config only (2 Mbp ref x 10 docs
at 1 % SNP, plain output — the headline number tracked across rounds); if
the primary config has no clean byte-equal entry they are -1.0 and
``headline_config`` is null — the headline never silently substitutes a
different config. ``configs`` carries one entry per BASELINE.md
deployment shape:

  primary      2 Mbp ref, 10 docs, 1 % SNP, plain      (headline)
  toy_lowdiv   1 Mbp ref, 10 docs, 0.1 % SNP, plain    (BASELINE config 1 —
               the reference's strongest regime: long PLCP skips)
  sars_stream  30 Kbp ref, ~25 Mchars of docs, -p cut  (BASELINE config 3
               shape: tiny reference, huge collection, prefix streaming)
  ecoli_rle    5 Mbp ref, 20 docs = 100 Mchars, -r     (BASELINE config 2
               shape at reduced doc count; BENCH_FULL=1 runs 100 docs)

Robustness contract (a run cut by an outer time limit prints nothing):
  * every config runs in a SUBPROCESS under a watchdog timeout, so a
    wedged XLA compile cannot strand the driver line;
  * a global wall-clock budget (BENCH_BUDGET_S, default 1500 s) is checked
    between configs — on expiry the remaining configs are recorded as
    skipped and the line prints with whatever completed;
  * the GPU probe COMPILES AND EXECUTES a small jitted program under
    timeout before any config runs; merely enumerating devices can pass
    while the compile path is wedged. Without a GPU the bench fails:
    it never measures on the CPU.

Per config: our timing is best-of-N after a warm-up compile run; the
reference binary is timed best-of-3 (best-of-2 above 100 Mchars) and the
spread (min..max) is printed so run-to-run noise on the shared host is
visible next to the ratio.

Env knobs:
  BENCH_CONFIGS     comma list to run (default: all four)
  BENCH_BUDGET_S    global wall-clock budget in seconds (default 1500)
  BENCH_CONFIG_TIMEOUT_S  hard per-config cap (default: per-config table)
  BENCH_FULL=1      full-scale ecoli (100 docs = 500 Mchars) + sars (90 Mchars)
  BENCH_REF_MBP / BENCH_DOCS / BENCH_SNP / BENCH_BACKEND / BENCH_BLOCK_CHARS
                    override the primary config (legacy single-config knobs)
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cmsbwt_tpu.utils.gpu import card_info, device_record  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent


def wrap_fasta(b: bytes, width=60) -> bytes:
    return b"\n".join(b[i:i + width] for i in range(0, len(b), width))


def make_workload(tmp: pathlib.Path, ref_mbp: float, ndocs: int, snp: float,
                  seed: int = 42):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = int(ref_mbp * 1e6)
    ref = rng.choice(alphabet, size=n)
    (tmp / "ref.fa").write_bytes(b">ref\n" + wrap_fasta(ref.tobytes()) + b"\n")
    with open(tmp / "coll.fa", "wb") as f:
        for i in range(ndocs):
            arr = ref.copy()
            k = max(1, int(n * snp))
            idx = rng.choice(n, k, replace=False)
            arr[idx] = rng.choice(alphabet, size=k)
            f.write(b">doc%d\n" % i + wrap_fasta(arr.tobytes()) + b"\n")
    lst = tmp / "input.txt"
    lst.write_bytes(str(tmp / "ref.fa").encode() + b"\n" +
                    str(tmp / "coll.fa").encode() + b"\n")
    return lst


def ensure_reference_binary() -> pathlib.Path | None:
    ref_bin = REPO / "baseline" / "cms-bwt-ref"
    if not ref_bin.exists():
        r = subprocess.run([str(REPO / "baseline" / "build.sh")],
                           capture_output=True)
        if r.returncode != 0:
            return None
    return ref_bin


def run_reference(tmp: pathlib.Path, lst: pathlib.Path, reps: int,
                  rle: bool = False,
                  prefix: int | None = None) -> tuple[float, float]:
    """(best, worst) wall-clock over ``reps`` runs of the C++ reference.

    A reference-binary crash or timeout returns (-1, -1) instead of raising
    so the already-measured ``ours`` timing survives in the entry."""
    ref_bin = ensure_reference_binary()
    if ref_bin is None:
        return -1.0, -1.0
    args = [str(ref_bin), "-o", str(tmp / "refout")]
    if rle:
        args.append("-r")
    if prefix is not None:
        args += ["-p", str(prefix)]
    args.append(str(lst))
    best, worst = float("inf"), 0.0
    for _ in range(reps):
        t0 = time.time()
        try:
            subprocess.run(args, check=True, capture_output=True,
                           timeout=1200)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
            print(f"# reference binary failed: {type(e).__name__}",
                  file=sys.stderr)
            return -1.0, -1.0
        dt = time.time() - t0
        best, worst = min(best, dt), max(worst, dt)
    return best, worst


def files_equal(a: pathlib.Path, b: pathlib.Path, chunk=1 << 24) -> bool:
    """Chunked comparison — full-file read_bytes() on the 500 MB BENCH_FULL
    outputs costs ~1 GB transient."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            ca, cb = fa.read(chunk), fb.read(chunk)
            if ca != cb:
                return False
            if not ca:
                return True


CONFIGS = {
    # name: (ref_mbp, docs, snp, rle, prefix, ours_reps, ref_reps, timeout_s)
    "primary": dict(ref_mbp=2.0, docs=10, snp=0.01, rle=False,
                    prefix=None, ours_reps=2, ref_reps=3, timeout_s=600,
                    cold=True),
    "toy_lowdiv": dict(ref_mbp=1.0, docs=10, snp=0.001, rle=False,
                       prefix=None, ours_reps=2, ref_reps=3, timeout_s=420),
    "sars_stream": dict(ref_mbp=0.03, docs=1000, snp=0.005, rle=False,
                        prefix=25_000_000, ours_reps=2, ref_reps=3,
                        timeout_s=600),
    "ecoli_rle": dict(ref_mbp=5.0, docs=20, snp=0.01, rle=True,
                      prefix=None, ours_reps=1, ref_reps=2, timeout_s=900),
    # dense identities: the primary and ecoli shapes FORCED onto the
    # dense joint-sort scan + device merge, so the pure on-device path is
    # tracked next to the dispatcher's pick
    "primary_dense": dict(ref_mbp=2.0, docs=10, snp=0.01, rle=False,
                          prefix=None, ours_reps=2, ref_reps=2,
                          timeout_s=900, backend="dense",
                          merge_backend="device"),
    "ecoli_dense": dict(ref_mbp=5.0, docs=20, snp=0.01, rle=True,
                        prefix=None, ours_reps=1, ref_reps=1,
                        timeout_s=1500, backend="dense",
                        merge_backend="device"),
    # sharded-merge perf identity: the primary shape with the mesh
    # sample-sort merge forced, so its single-host overhead
    # vs the device merge is on record
    "primary_shmerge": dict(ref_mbp=2.0, docs=10, snp=0.01, rle=False,
                            prefix=None, ours_reps=1, ref_reps=1,
                            timeout_s=420, backend="dense",
                            merge_backend="sharded"),
}
FULL_OVERRIDES = {
    "sars_stream": dict(docs=3000, prefix=80_000_000, timeout_s=1800),
    "ecoli_rle": dict(docs=100, timeout_s=3600),
}


def run_one_config(name: str, spec: dict,
                   backend_override: str | None,
                   block_override: str | None) -> dict:
    import jax

    from cmsbwt_tpu.config import Config
    from cmsbwt_tpu.engine.pipeline import compute_bwt

    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"cmsbench_{name}_"))
    lst = make_workload(tmp, spec["ref_mbp"], spec["docs"], spec["snp"])

    # "auto" measures the real dispatcher (divergence probe + regime
    # routing); BENCH_BACKEND or a per-config "backend" forces an engine
    backend = backend_override or spec.get("backend") or "auto"
    # None lets the dense scan's memory guard size blocks from the device
    block_chars = int(block_override) if block_override else None

    kwargs = dict(filename=str(lst), outname=str(tmp / "ours"),
                  backend=backend, rle=spec["rle"],
                  dense_block_chars=block_chars,
                  merge_backend=spec.get("merge_backend", "auto"))
    if spec["prefix"]:
        kwargs["prefix_length"] = spec["prefix"]
    cfg = Config(**kwargs)
    if os.environ.get("BENCH_CPU_LANES"):
        from dataclasses import replace
        cfg = replace(cfg, lanes=int(os.environ["BENCH_CPU_LANES"]))

    # warm-up run compiles all kernels (persistent XLA cache); then best-of-N
    compute_bwt(cfg)
    ours_s = float("inf")
    for _ in range(spec["ours_reps"]):
        t0 = time.time()
        out = compute_bwt(cfg)
        ours_s = min(ours_s, time.time() - t0)
        print(f"# [{name}] phases: "
              + out["timer"].report().replace("\n", " | "), file=sys.stderr)
    sn = out["result"].sn
    backend = out.get("backend") or backend   # resolved engine
    ours_rate = sn / 1e6 / ours_s

    # cold-cache honesty: the primary entry re-runs once against a FRESH
    # index/probe cache dir, so the JSON carries the first-ever-run cost
    # next to the steady-state number (XLA programs stay cached)
    cold_s = None
    if spec.get("cold"):
        from dataclasses import replace as _dc_replace
        cfg_cold = _dc_replace(cfg, outname=str(tmp / "ours_cold"),
                               index_cache_dir=str(tmp / "cold_idx"))
        t0 = time.time()
        compute_bwt(cfg_cold)
        cold_s = round(time.time() - t0, 3)

    # dispatcher transparency: record the divergence probe's answer next
    # to the engine the run actually used
    probe_frac = None
    if (backend_override or spec.get("backend") or "auto") == "auto":
        try:
            from cmsbwt_tpu.engine.probe import kmer_absent_fraction
            from cmsbwt_tpu.io import fasta as _fa
            _x = _fa.augment_reference(
                _fa.load_reference_bytes(str(tmp / "ref.fa")))
            _c = _fa.parse_collection(str(tmp / "coll.fa"),
                                      spec["prefix"] or (1 << 62))
            _f = kmer_absent_fraction(_x, _c.sx)
            probe_frac = None if _f is None else round(float(_f), 4)
        except Exception:
            pass

    ref_best, ref_worst = run_reference(tmp, lst, spec["ref_reps"],
                                        rle=spec["rle"],
                                        prefix=spec["prefix"])
    equal = None
    vs = -1.0
    if ref_best > 0:
        ext = ".rl_bwt" if spec["rle"] else ".bwt"
        equal = files_equal(tmp / ("ours" + ext), tmp / ("refout" + ext))
        vs = ref_best / ours_s
    entry = {
        "config": name, "ref_mbp": spec["ref_mbp"], "docs": spec["docs"],
        "snp": spec["snp"], "rle": spec["rle"], "prefix": spec["prefix"],
        "sn": int(sn), "backend": backend,
        "merge_backend": spec.get("merge_backend", "auto"),
        "ours_s": round(ours_s, 3), "tput_mchars_s": round(ours_rate, 3),
        "ref_s_best": round(ref_best, 3), "ref_s_worst": round(ref_worst, 3),
        "vs_baseline": round(vs, 4), "byte_equal": equal,
        "cold_s": cold_s, "probe_frac": probe_frac,
        "device": device_record(jax.devices()), "card": card_info(),
    }
    print(f"# [{name}] sn={sn} ours={ours_s:.2f}s "
          f"ref={ref_best:.2f}..{ref_worst:.2f}s ({spec['ref_reps']} runs) "
          f"vs={vs:.3f} byte_equal={equal} backend={backend}",
          file=sys.stderr)
    return entry


def apply_env_overrides() -> list[str] | None:
    """Mutate CONFIGS from the env knobs; returns the explicit config-name
    list (or None = all). Called in BOTH the parent and the --run-config
    child (the child re-imports this module, so parent-side mutation alone
    would silently run default shapes)."""
    legacy = any(k in os.environ for k in
                 ("BENCH_REF_MBP", "BENCH_DOCS", "BENCH_SNP"))
    names = os.environ.get("BENCH_CONFIGS")
    if legacy:
        names = ["primary"]
        CONFIGS["primary"].update(
            ref_mbp=float(os.environ.get("BENCH_REF_MBP", "2")),
            docs=int(os.environ.get("BENCH_DOCS", "10")),
            snp=float(os.environ.get("BENCH_SNP", "0.01")))
    elif names:
        names = [s.strip() for s in names.split(",") if s.strip()]
    if os.environ.get("BENCH_FULL"):
        for k, ov in FULL_OVERRIDES.items():
            CONFIGS[k].update(ov)
    return names


def child_main(name: str, emit: str) -> None:
    """--run-config child: run one config, write its JSON entry to ``emit``.

    Runs in its own process so the parent's watchdog can kill a wedged XLA
    compile without losing the driver line."""
    apply_env_overrides()
    spec = CONFIGS[name]
    try:
        entry = run_one_config(name, spec,
                               os.environ.get("BENCH_BACKEND"),
                               os.environ.get("BENCH_BLOCK_CHARS"))
    except Exception as e:
        entry = {"config": name,
                 "error": f"{type(e).__name__}: {str(e)[:200]}"}
        print(f"# [{name}] FAILED: {type(e).__name__}: {str(e)[:300]}",
              file=sys.stderr)
    pathlib.Path(emit).write_text(json.dumps(entry))


def probe_gpu(timeout_s: float = 150.0) -> dict:
    """The GPU as JAX reports it (platform, kind, count), once a jitted
    program has COMPILED AND EXECUTED on it within the timeout: a device
    list alone can look healthy while the compile path is wedged. Runs in
    a child process, so the parent never holds the card. Exits the bench
    when there is no working GPU."""
    code = (
        "import json, jax, jax.numpy as jnp\n"
        "from cmsbwt_tpu.utils.gpu import device_record, require_gpu\n"
        "devices = require_gpu()\n"
        "r = jax.jit(lambda x: (x * 2 + 1).sum())"
        "(jnp.ones(1024, jnp.float32))\n"
        "assert float(r) == 3072.0\n"
        "print(json.dumps(device_record(devices)))\n")
    try:
        probe = subprocess.run([sys.executable, "-u", "-c", code],
                               capture_output=True, text=True,
                               timeout=timeout_s, check=False, cwd=REPO)
    except subprocess.TimeoutExpired:
        raise SystemExit(f"GPU probe timed out after {timeout_s:.0f}s")
    if probe.returncode != 0:
        raise SystemExit("GPU probe failed:\n" + probe.stderr[-2000:])
    return json.loads(probe.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-config", help="child mode: run one named config")
    ap.add_argument("--emit", help="child mode: write the entry JSON here")
    cli = ap.parse_args()
    if cli.run_config:
        child_main(cli.run_config, cli.emit)
        return

    t_start = time.time()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "2400"))

    # legacy single-config override: if any BENCH_REF_MBP/DOCS/SNP knob is
    # set, run ONLY the primary config with those values
    names = apply_env_overrides() or list(CONFIGS)

    device = probe_gpu()
    card = card_info()
    print(f"# {device['kind']} x {device['count']}: {card}", file=sys.stderr)

    cap_override = os.environ.get("BENCH_CONFIG_TIMEOUT_S")
    entries = []
    for name in names:
        elapsed = time.time() - t_start
        remaining = budget_s - elapsed
        if remaining < 90:
            entries.append({"config": name,
                            "error": "skipped: bench budget exhausted"})
            print(f"# [{name}] skipped: {remaining:.0f}s left of "
                  f"{budget_s:.0f}s budget", file=sys.stderr)
            continue
        cap = float(cap_override) if cap_override else \
            float(CONFIGS[name].get("timeout_s", 600))
        cap = min(cap, remaining)
        emit = tempfile.NamedTemporaryFile(suffix=".json", delete=False)
        emit.close()
        print(f"# [{name}] starting (cap {cap:.0f}s, "
              f"{remaining:.0f}s budget left)", file=sys.stderr)
        try:
            subprocess.run(
                [sys.executable, "-u", __file__, "--run-config", name,
                 "--emit", emit.name],
                timeout=cap, check=False,
                stdout=sys.stderr.fileno(), stderr=sys.stderr.fileno())
        except subprocess.TimeoutExpired:
            print(f"# [{name}] watchdog timeout after {cap:.0f}s",
                  file=sys.stderr)
        try:
            text = pathlib.Path(emit.name).read_text()
            entry = json.loads(text) if text.strip() else {
                "config": name, "error": f"timeout after {cap:.0f}s"}
        except Exception:
            entry = {"config": name, "error": f"timeout after {cap:.0f}s"}
        finally:
            os.unlink(emit.name)
        entries.append(entry)

    # headline = primary, clean and byte-equal (byte_equal None = reference
    # binary unavailable, still reportable; False = disqualified)
    head = next((e for e in entries
                 if e.get("config") == "primary" and "error" not in e
                 and e.get("byte_equal") is not False), None)
    line = {
        "metric": "cms_bwt_end_to_end_throughput",
        "value": head["tput_mchars_s"] if head else -1.0,
        "unit": "Mchars/s",
        "vs_baseline": head["vs_baseline"] if head else -1.0,
        "platform": device["platform"],
        "headline_config": "primary" if head else None,
        "wall_s": round(time.time() - t_start, 1),
        "configs": entries,
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
