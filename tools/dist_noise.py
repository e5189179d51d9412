"""One model's ``chip_smoke.py`` two-rank lines against its noise references, alone (needs the card).

Runs the one-process references of ``chip_smoke.DIST_NOISE`` for one
model (the Llama's 2 of 32 layers, or the Mixtral layer), then the named
``DIST_LINES`` of that model in the two-rank world on the one card, and
prints one JSON line: each noise pair's distance and its
``DIST_TOL_FACTOR`` limits, each line's distance from the ``one`` run, its
launches a rank, and whether it stays within its limits::

    python tools/dist_noise.py llama dist_sp2
    python tools/dist_noise.py moe dist_ep2

The package comes first on the path, ``chip_smoke.py`` from this checkout,
so a run from another checkout's directory (``PYTHONPATH=<checkout>``)
holds that checkout's package to the same limits.  Exits 1 when a line
leaves its limits.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(model: str, names) -> int:
    sys.path.append(ROOT)
    import chip_smoke as cs
    from accelerate_tpu_torch.ops import _build

    _build.load()
    pairs = {noise: pair for noise, (m, *pair) in cs.DIST_NOISE.items() if m == model}
    labels = ["one", *sorted({lab for pair in pairs.values() for lab in pair} - {"one"})]
    out = {"gpu": cs.gpu_line(), "package": os.path.dirname(_build.__file__)}
    out_dir = tempfile.mkdtemp(prefix="dist_noise_")
    try:
        runs = cs.dist_reference_runs(model, labels)
        limits = {}
        for noise, (base, twin) in pairs.items():
            diff = cs._dist_diffs(runs[twin]["loss"], runs[twin]["grad_norm"], runs[base],
                                  got_weights=runs[twin]["weights"])
            limits[noise] = {k: cs.DIST_TOL_FACTOR * v for k, v in diff.items()}
            out[noise] = {"pair": [base, twin], "noise": diff, "limits": limits[noise]}
        torch.save(runs["one"].pop("weights"), os.path.join(out_dir, f"one_weights_{model}.pt"))
        one = runs["one"]
        del runs
        cs.free_card(host=True)
        lines = [line for line in cs.DIST_LINES if line["name"] in names]
        cs.run_ranks(cs.dist_rank, (out_dir, lines), 2, "the two-rank world")
        ranks = [json.load(open(os.path.join(out_dir, f"rank_{r}.json"))) for r in range(2)]
        ok = True
        for line in lines:
            per = [r[line["name"]] for r in ranks]
            norms = [n for n, a in zip(per[0]["grad_norm"], per[0]["applied"]) if a]
            diff = cs._dist_diffs(per[0]["loss"], norms, one, weight_rel=per[0]["weight_rel"])
            lim = limits[line.get("noise", model)]
            within = all(diff[k] <= lim[k] for k in lim)
            ok = ok and within
            out[line["name"]] = {"vs_one_process": diff, "within_limits": within,
                                 "launches_per_rank": [r["launches"] for r in per],
                                 "loss": per[0]["loss"], "one_loss": one["loss"]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:]))
