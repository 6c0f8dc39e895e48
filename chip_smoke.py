"""Smoke run of the CMS-BWT device pipeline on NVIDIA GPUs.

    python chip_smoke.py           # phases A-F on one GPU
    python chip_smoke.py --four    # the mesh paths, on four GPUs

Each phase drives a user entry point (the CLI's ``main`` or
``compute_bwt``) twice on inputs that ``bench.make_workload`` generates
from a fixed seed, and checks both outputs byte for byte against the
reference binary (``baseline/cms-bwt-ref``) on the same inputs, or against
an earlier phase's output. The pipeline is integer-only, so byte equality
is the whole correctness statement. For each phase the script prints the
engine that ran, the phase timer of the warm run, the wall time of the
first and the second run, the programs each run compiled or loaded from
the persistent compile cache (``programs``; ``cache_loads`` of them
loaded), the device's peak and limit bytes, and the verdict. The last line is the JSON contract line
``{"ok": true, "device": {...}}``; an exception or a mismatch in any phase
exits non-zero before it. Anything but a GPU is refused.

One-card phases:
  A  5 Mbp x 20 docs, 1 % SNP, -r: dense scan + device merge, unblocked
  B  A's inputs in 32 Mi-symbol blocks, device merge         (vs A)
  C  1 Mbp x 10 docs, 0.1 % SNP: jump scan + device merge
  D  2 Mbp x 10 docs, 1 % SNP: --backend auto
  E  D's inputs: dense scan + sharded merge on one shard      (vs D)
  F  1 Mbp x 4 docs, 1 % SNP: lane scan (backend=device)
Four-card phases (--four):
  a  2 Mbp x 40 docs, 1 % SNP: mesh scan (--parallel) + sharded merge
  b  a's inputs through the giant route: the sharded int64 reference
     index is built over the four cards
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

REPO = pathlib.Path(__file__).resolve().parent
REF_BIN = REPO / "baseline" / "cms-bwt-ref"

# Generated workloads: the shapes of bench.py's cells (ecoli_rle,
# toy_lowdiv, primary) at their bench sizes.
WORKLOADS = {
    "ecoli": dict(ref_mbp=5.0, docs=20, snp=0.01, rle=True),
    "lowdiv": dict(ref_mbp=1.0, docs=10, snp=0.001, rle=False),
    "primary": dict(ref_mbp=2.0, docs=10, snp=0.01, rle=False),
    "lanes": dict(ref_mbp=1.0, docs=4, snp=0.01, rle=False),
    "mesh": dict(ref_mbp=2.0, docs=40, snp=0.01, rle=False),
}
BLOCK_CHARS = 32 << 20          # phase B's block size, in symbols
ONE_CARD_PHASES = "ABCDEF"
FOUR_CARD_PHASES = "ab"
# fired once per program XLA compiles or loads from the persistent cache
BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
CACHE_HIT = "/jax/compilation_cache/cache_hits"


def run_cli(argv: list[str]) -> dict:
    """Run the CLI's ``main`` in-process and return the result dict of the
    ``compute_bwt`` call it made."""
    from cmsbwt_tpu import cli
    from cmsbwt_tpu.engine import pipeline
    real = pipeline.compute_bwt
    seen = {}

    def recording(cfg):
        seen["out"] = real(cfg)
        return seen["out"]

    pipeline.compute_bwt = recording
    try:
        rc = cli.main(argv)
    finally:
        pipeline.compute_bwt = real
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return seen["out"]


class Smoke:
    """Workloads, reference outputs and phase records of one smoke run.

    Each workload's reference-binary process starts when its inputs are
    made, so it runs beside the device phases; ``close`` kills any still
    running."""

    def __init__(self, workdir, workloads: dict = WORKLOADS,
                 block_chars: int = BLOCK_CHARS):
        import jax
        self.workdir = pathlib.Path(workdir)
        self.workloads = workloads
        self.block_chars = block_chars
        self.records: list[dict] = []
        self._inputs: dict[str, pathlib.Path] = {}
        # workload -> (reference-binary process, its output file)
        self._references: dict[str, tuple] = {}
        self._outputs: dict[str, pathlib.Path] = {}
        self._compiles: list[float] = []
        self._cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        jax.monitoring.register_event_listener(self._on_hit)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        import jax
        jax.monitoring.unregister_event_duration_listener(self._on_event)
        jax.monitoring.unregister_event_listener(self._on_hit)
        for proc, _ in self._references.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event == BACKEND_COMPILE:
            self._compiles.append(duration)

    def _on_hit(self, event: str, **_) -> None:
        if event == CACHE_HIT:
            self._cache_hits += 1

    # --- inputs and what each phase is compared with ----------------------

    def inputs(self, workload: str) -> pathlib.Path:
        """Input list of ``workload``, generated on first use; its
        reference-binary run starts at the same time."""
        if workload not in self._inputs:
            from bench import make_workload
            spec = self.workloads[workload]
            wdir = self.workdir / workload
            wdir.mkdir(parents=True)
            lst = make_workload(wdir, spec["ref_mbp"], spec["docs"],
                                spec["snp"])
            self._inputs[workload] = lst
            out = wdir / "reference"
            args = [str(REF_BIN), "-o", str(out)] + (
                ["-r"] if spec["rle"] else []) + [str(lst)]
            with open(wdir / "reference.err", "wb") as err:
                proc = subprocess.Popen(args, stdout=subprocess.DEVNULL,
                                        stderr=err)
            self._references[workload] = (proc, pathlib.Path(
                str(out) + (".rl_bwt" if spec["rle"] else ".bwt")))
        return self._inputs[workload]

    def reference(self, workload: str) -> pathlib.Path:
        """The reference binary's output on ``workload``."""
        self.inputs(workload)
        proc, out = self._references[workload]
        if proc.wait(timeout=1200) != 0:
            err = (out.parent / "reference.err").read_text(errors="replace")
            raise RuntimeError(f"reference binary exited {proc.returncode}: "
                               f"{err[-500:]}")
        return out

    def output(self, phase: str) -> pathlib.Path:
        """Output file of ``phase``, running the phase if it has not run."""
        if phase not in self._outputs:
            self.run_phase(phase)
        return self._outputs[phase]

    # --- the phases ---------------------------------------------------------

    def run_phase(self, phase: str) -> dict:
        return getattr(self, f"phase_{phase}")()

    def phase_A(self) -> dict:
        from cmsbwt_tpu.io import fasta
        from cmsbwt_tpu.utils.jaxcache import bucket_size
        lst = self.inputs("ecoli")
        rec = self._measure(
            "A", "ecoli", "dense scan + device merge, unblocked, RLE (CLI)",
            lambda out: run_cli(["--backend", "dense", "--merge-backend",
                                 "device", "-r", "-o", out, str(lst)]),
            lambda: self.reference("ecoli"), "reference binary")
        # the dense scan's memory guard (engine/pipeline.py) charges
        # BYTES_PER_SYMBOL per bucketed joint-string symbol
        n = len(fasta.augment_reference(fasta.load_reference_bytes(
            fasta.read_input_list(str(lst))[0])))
        symbols = bucket_size(n) + bucket_size(rec["sn"] + 1)
        peak = rec["peak_bytes_in_use"][0]
        print(f"phase A: {symbols} bucketed symbols"
              + (f", {peak / symbols:.1f} peak bytes per symbol"
                 if peak is not None else ""))
        return rec

    def phase_B(self) -> dict:
        return self._measure(
            "B", "ecoli",
            f"dense scan in {self.block_chars}-symbol blocks, device merge",
            lambda out: self._run_config(
                "ecoli", out, backend="dense", merge_backend="device",
                dense_block_chars=self.block_chars),
            lambda: self.output("A"), "phase A")

    def phase_C(self) -> dict:
        return self._measure(
            "C", "lowdiv", "jump scan + device merge",
            lambda out: self._run_config("lowdiv", out, backend="jump",
                                         merge_backend="device"),
            lambda: self.reference("lowdiv"), "reference binary")

    def phase_D(self) -> dict:
        from cmsbwt_tpu.config import Config
        from cmsbwt_tpu.engine.probe import kmer_absent_fraction
        from cmsbwt_tpu.io import fasta
        lst = self.inputs("primary")
        ref_path, coll_path = fasta.read_input_list(str(lst))
        cfg = Config()
        frac = kmer_absent_fraction(
            fasta.augment_reference(fasta.load_reference_bytes(ref_path)),
            fasta.parse_collection(coll_path, cfg.prefix_length).sx,
            k=cfg.probe_kmer, samples=cfg.probe_samples,
            ref_cap=cfg.probe_ref_cap)
        print(f"phase D: probe k-mer absent fraction {frac} "
              f"(threshold {cfg.probe_threshold})")
        return self._measure(
            "D", "primary", "--backend auto (CLI)",
            lambda out: run_cli(["--backend", "auto", "-o", out, str(lst)]),
            lambda: self.reference("primary"), "reference binary")

    def phase_E(self) -> dict:
        return self._measure(
            "E", "primary", "dense scan + sharded merge",
            lambda out: self._run_config("primary", out, backend="dense",
                                         merge_backend="sharded"),
            lambda: self.output("D"), "phase D")

    def phase_F(self) -> dict:
        return self._measure(
            "F", "lanes", "lane scan (backend=device)",
            lambda out: self._run_config("lanes", out, backend="device"),
            lambda: self.reference("lanes"), "reference binary")

    def phase_a(self) -> dict:
        import jax
        from cmsbwt_tpu.io import fasta
        coll_path = fasta.read_input_list(str(self.inputs("mesh")))[1]
        sn = fasta.parse_collection(coll_path, 1 << 62).sn
        ndev = len(jax.devices())
        block = -(-sn // ndev)
        return self._measure(
            "a", "mesh",
            f"mesh dense scan, {block}-symbol blocks over {ndev} devices, "
            "sharded merge",
            lambda out: self._run_config(
                "mesh", out, backend="dense", dense_parallel=True,
                dense_block_chars=block, merge_backend="sharded"),
            lambda: self.reference("mesh"), "reference binary")

    def phase_b(self) -> dict:
        from cmsbwt_tpu.io import fasta
        lst = self.inputs("mesh")
        n = len(fasta.augment_reference(fasta.load_reference_bytes(
            fasta.read_input_list(str(lst))[0])))
        threshold = n // 2
        saved = os.environ.get("CMSBWT_GIANT_THRESHOLD")
        os.environ["CMSBWT_GIANT_THRESHOLD"] = str(threshold)
        try:
            return self._measure(
                "b", "mesh",
                f"giant route (threshold {threshold} < reference {n}): "
                "sharded int64 index",
                lambda out: self._run_config("mesh", out, backend="auto"),
                lambda: self.reference("mesh"), "reference binary")
        finally:
            if saved is None:
                del os.environ["CMSBWT_GIANT_THRESHOLD"]
            else:
                os.environ["CMSBWT_GIANT_THRESHOLD"] = saved

    def _run_config(self, workload: str, outname: str, **kw) -> dict:
        """``compute_bwt`` on ``workload`` with the Config fields ``kw``."""
        from cmsbwt_tpu.config import Config
        from cmsbwt_tpu.engine.pipeline import compute_bwt
        return compute_bwt(Config(
            filename=str(self.inputs(workload)), outname=outname,
            rle=self.workloads[workload]["rle"], **kw))

    # --- measuring one phase ------------------------------------------------

    def _measure(self, phase: str, workload: str, what: str, run,
                 expected, against: str) -> dict:
        """Run ``run(outname)`` twice, compare both outputs with the file
        ``expected()`` returns, print and keep the phase's record."""
        import jax
        from bench import files_equal
        runs = []
        for i in (1, 2):
            before, hits = len(self._compiles), self._cache_hits
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out = run(str(self.workdir / workload / f"{phase}{i}"))
                wall = time.perf_counter() - t0
            compiles = self._compiles[before:]
            runs.append(dict(
                out=out, wall_s=wall, programs=len(compiles),
                cache_loads=self._cache_hits - hits,
                programs_over_1s=sum(d >= 1.0 for d in compiles),
                compile_s=sum(compiles),
                int64_truncated=sum("truncated" in str(w.message)
                                    for w in caught)))
        want = expected()
        equal = all(files_equal(pathlib.Path(r["out"]["out_path"]), want)
                    for r in runs)
        stats = [d.memory_stats() or {} for d in jax.devices()]
        rec = dict(
            phase=phase, what=what, engine=runs[-1]["out"]["backend"],
            sn=int(runs[-1]["out"]["result"].sn),
            first_s=runs[0]["wall_s"], warm_s=runs[1]["wall_s"],
            **{k: [r[k] for r in runs] for k in (
                "programs", "cache_loads", "programs_over_1s",
                "compile_s", "int64_truncated")},
            peak_bytes_in_use=[s.get("peak_bytes_in_use") for s in stats],
            bytes_limit=[s.get("bytes_limit") for s in stats],
            against=against, byte_equal=equal)
        self._outputs[phase] = pathlib.Path(runs[-1]["out"]["out_path"])
        self.records.append(rec)
        print(f"phase {phase} timer: "
              + runs[-1]["out"]["timer"].report().replace("\n", " | "))
        print(f"phase {phase} {json.dumps(rec)}", flush=True)
        return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh paths, on exactly four GPUs")
    args = ap.parse_args(argv)
    from cmsbwt_tpu.utils.gpu import card_info, device_record, require_gpu
    devices = require_gpu(4 if args.four else None)
    # every reference index is built on the card in this run, never
    # loaded from an earlier run's disk cache
    os.environ["CMSBWT_INDEX_CACHE"] = ""
    print(f"card: {card_info()}")
    print(f"jax: {devices[0].device_kind} x {len(devices)}", flush=True)
    phases = FOUR_CARD_PHASES if args.four else ONE_CARD_PHASES
    workloads = ["mesh"] if args.four else ["ecoli", "lowdiv", "primary",
                                            "lanes"]
    with tempfile.TemporaryDirectory(prefix="cmsbwt_smoke_") as tmp, \
            Smoke(tmp) as smoke:
        for w in workloads:
            smoke.inputs(w)
        for phase in phases:
            smoke.run_phase(phase)
    failed = [r["phase"] for r in smoke.records if not r["byte_equal"]]
    if failed:
        raise SystemExit(f"outputs differ in phase(s) {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
