"""Two actual processes: a jax.distributed CPU
cluster (localhost coordinator, 2 processes x 4 virtual devices) runs the
mesh scan + the sharded merge across the process boundary, and the result
must be byte-equal to the single-process engine.

This is the test that converts parallel/distributed.py from bring-up
scaffolding into exercised code: the wave program's ppermute chain and
every dsort bucket exchange cross between the worker processes (Gloo
collectives on the CPU backend)."""
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from cmsbwt_tpu.engine import device_merge as DM
from cmsbwt_tpu.io import fasta
from cmsbwt_tpu.io.fasta import augment_reference
from cmsbwt_tpu.ops.ms_dense import ms_dense_heads

from helpers import make_fasta, mutate, random_dna

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_scan_and_sharded_merge(tmp_path):
    port = _free_port()
    workers = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "dist_worker.py"),
             str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for w in workers:
        try:
            out, _ = w.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for x in workers:
                x.kill()
            raise
        outs.append(out)
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"

    got = np.load(tmp_path / "result.npz")

    # single-process oracle on the identical deterministic inputs
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.03) for _ in range(4)]
    x_aug = augment_reference(ref)
    cp = tmp_path / "coll_oracle.fa"
    cp.write_bytes(make_fasta(docs))
    coll = fasta.parse_collection(str(cp), 2**64 - 1)
    dres = ms_dense_heads(x_aug, coll.sx)
    rl0, rc0, _ = DM.merge_heads_numpy(
        dres.head_t, dres.head_pos, dres.head_len, dres.head_smaller,
        dres.head_char, dres.ref_sa, dres.ref_isa, dres.ref_bwt,
        dres.h, len(x_aug), dres.sn, coll.d, rle_quirk=False)

    assert int(got["h"]) == dres.h

    def expand(rl, rc):
        return np.repeat(np.asarray(rc, np.uint8), np.asarray(rl))

    np.testing.assert_array_equal(expand(got["rl"], got["rc"]),
                                  expand(rl0, rc0))
