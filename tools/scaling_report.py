"""Scaling-efficiency report over the virtual device mesh.

Runs the mesh-native dense scan (parallel/mesh.py) and the sharded merge
(parallel/sharded_merge.py) on the SAME workload at 1/2/4/8 virtual CPU
devices and reports per-device throughput + scaling efficiency vs the
1-device run. The virtual devices share the host's cores, so the numbers
measure the HARNESS (the collective/overhead share of the sharded
formulation), not the scaling of real devices; it is a rehearsal of the
mesh paths, not a device measurement.

Usage: python tools/scaling_report.py [out.json]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def _workload(sn_target=4_000_000, ref_len=1 << 17, seed=7):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(alpha, size=ref_len)
    n_docs = max(1, sn_target // (ref_len + 1))
    parts = []
    for _ in range(n_docs):
        d = ref.copy()
        idx = rng.choice(ref_len, ref_len // 100, replace=False)
        d[idx] = rng.choice(alpha, size=len(idx))
        parts.append(np.concatenate([d, np.array([2], np.uint8)]))
    sx = np.concatenate([np.array([2], np.uint8)] + parts)
    from cmsbwt_tpu.io.fasta import augment_reference
    return augment_reference(ref.tobytes()), sx


def main():
    from cmsbwt_tpu.engine.device_merge import merge_heads_numpy
    from cmsbwt_tpu.parallel.mesh import make_mesh, ms_dense_heads_mesh
    from cmsbwt_tpu.parallel.sharded_merge import merge_heads_sharded

    x_aug, sx = _workload()
    sn = len(sx)
    n = len(x_aug)
    d = int((sx == 2).sum())
    rows = []
    base_rate = None
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        block = max(64, -(-sn // nd))
        # warm compile, then timed
        res = ms_dense_heads_mesh(x_aug, sx, block_chars=block, mesh=mesh)
        t0 = time.time()
        res = ms_dense_heads_mesh(x_aug, sx, block_chars=block, mesh=mesh)
        scan_s = time.time() - t0
        merge_heads_sharded(res.head_t, res.head_pos, res.head_len,
                            res.head_smaller, res.head_char, res.ref_sa,
                            res.ref_isa, res.ref_bwt, res.h, n, res.sn, d,
                            False, n_devices=nd)
        t0 = time.time()
        rl, rc = merge_heads_sharded(
            res.head_t, res.head_pos, res.head_len, res.head_smaller,
            res.head_char, res.ref_sa, res.ref_isa, res.ref_bwt,
            res.h, n, res.sn, d, False, n_devices=nd)
        merge_s = time.time() - t0
        total = scan_s + merge_s
        rate = sn / 1e6 / total
        per_dev = rate / nd
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        rows.append(dict(n_devices=nd, scan_s=round(scan_s, 3),
                         merge_s=round(merge_s, 3),
                         tput_mchars_s=round(rate, 3),
                         per_device_mchars_s=round(per_dev, 3),
                         scaling_efficiency=round(eff, 3)))
        print(f"# nd={nd} scan={scan_s:.2f}s merge={merge_s:.2f}s "
              f"rate={rate:.2f} M/s eff={eff:.2f}", file=sys.stderr)
    out = dict(kind="virtual_cpu_mesh_scaling", sn=sn, n=n,
               note="virtual devices share the host's cores; measures the "
                    "sharded formulation's overhead share, not device "
                    "scaling",
               rows=rows)
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
