#!/usr/bin/env python3
"""The ``multilevel`` preset's coarsening ladder on a box mesh, for
comparing two hosts' NumPy builds on the same input.

    python3 tools/ml_ladder.py [--dims 80 64 48] [--nparts 64]
                               [--dump OUT.npz] [--against IN.npz]

Runs `repro_torch`'s ``multilevel`` preset (``guard=False``, on the CPU:
the V-cycle is host NumPy) on ``box_mesh(*dims)`` up to and including
the coarsest graph's dense spectral split, then stops.  It prints one
JSON line: the NumPy version, each matching's (fine nodes, coarse nodes,
first 12 hex digits of the SHA-1 of the int64 aggregation map; the last
one is dropped, not a level, when it coarsens by less than 5%), the
SHA-1 of the coarsest graph (CSR arrays and node weights) and of its
spectral parts, and the coarsest Laplacian's five lowest eigenvalues.
``--dump`` writes the coarsest graph and its parts to an ``.npz``;
``--against`` reads such a file (made on another host) and reports
whether the coarsest graph is the same and on how many nodes the two
hosts' spectral parts differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.core.multilevel as ml  # noqa: E402
from repro_torch.configs.parrsb import make_pipeline  # noqa: E402
from repro_torch.mesh import box_mesh  # noqa: E402


class _Coarsest(Exception):
    pass


def _sha(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs=3, default=(80, 64, 48))
    ap.add_argument("--nparts", type=int, default=64)
    ap.add_argument("--dump")
    ap.add_argument("--against")
    args = ap.parse_args(argv)

    ladder = []
    matching = ml.heavy_edge_matching
    spectral = ml._dense_spectral_parts
    found = {}

    def hem(g, **kw):
        agg, n_c = matching(g, **kw)
        ladder.append((int(g.n), int(n_c),
                       _sha(np.asarray(agg).astype(np.int64))))
        return agg, n_c

    def coarsest(g, w, nparts):
        parts = spectral(g, w, nparts)
        found.update(graph=g, w=np.asarray(w, np.float64), parts=parts)
        raise _Coarsest

    ml.heavy_edge_matching, ml._dense_spectral_parts = hem, coarsest
    try:
        make_pipeline("multilevel", guard=False, device="cpu").run(
            box_mesh(*args.dims), args.nparts)
    except _Coarsest:
        pass
    finally:
        ml.heavy_edge_matching, ml._dense_spectral_parts = matching, spectral
    if not found:
        print("the ladder never reached a dense spectral split",
              file=sys.stderr)
        return 1

    g, w, parts = found["graph"], found["w"], found["parts"]
    arrays = dict(indptr=np.asarray(g.indptr, np.int64),
                  indices=np.asarray(g.indices, np.int64),
                  weights=np.asarray(g.weights, np.float64), w=w,
                  parts=np.asarray(parts, np.int64))
    lap = np.diag(np.bincount(np.repeat(np.arange(g.n),
                                        np.diff(arrays["indptr"])),
                              weights=arrays["weights"], minlength=g.n))
    np.subtract.at(lap, (np.repeat(np.arange(g.n), np.diff(arrays["indptr"])),
                         arrays["indices"]), arrays["weights"])
    row = dict(numpy=np.__version__, dims=list(args.dims),
               nparts=args.nparts, ladder=ladder, n_coarsest=int(g.n),
               coarsest_graph=_sha(arrays["indptr"], arrays["indices"],
                                   arrays["weights"], w),
               coarsest_parts=_sha(arrays["parts"]),
               lowest_eigenvalues=[float(x) for x in
                                   np.linalg.eigvalsh(lap)[:5]])
    if args.dump:
        np.savez(args.dump, **arrays)
    if args.against:
        other = np.load(args.against)
        row["same_coarsest_graph"] = all(
            np.array_equal(arrays[k], other[k])
            for k in ("indptr", "indices", "weights", "w"))
        row["parts_differ_on"] = int((arrays["parts"] != other["parts"]).sum())
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
