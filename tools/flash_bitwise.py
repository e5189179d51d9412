"""K3-K5 outputs of two checkouts on the same inputs, compared bit for bit (needs the card).

``chip_smoke.py``'s flash cases (``FLASH_CASES``) run through the
``accelerate_tpu_torch`` package found first on the path: the forward's
``(out, lse)`` and, fed the plain forward's ``lse`` and ``delta``, K4's dQ
and K5's dK and dV.  Each case's tensors are written to a ``.pt`` file::

    python tools/flash_bitwise.py dump new.pt
    PYTHONPATH=../other_checkout python tools/flash_bitwise.py dump old.pt
    python tools/flash_bitwise.py compare old.pt new.pt

``compare`` prints one JSON line: each case's tensors equal or not, and
exits 1 unless every tensor of every case is bitwise equal.  The kernels
are built by each package into its own ``ops/build``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(path: str) -> None:
    sys.path.append(ROOT)  # chip_smoke's cases; the package comes first on the path
    import chip_smoke
    from accelerate_tpu_torch.ops import flash_attention as fa

    out = {"package": os.path.dirname(os.path.dirname(fa.__file__)), "cases": {}}
    for case in chip_smoke.FLASH_CASES:
        label, seed, b, s, hq, hkv, dtype, causal, segmented, *rest = case
        d = rest[0] if rest else 128
        q, k, v, dout, seg, _ = chip_smoke.flash_inputs(seed, b, s, hq, hkv, d, dtype, segmented)
        kw = dict(causal=causal, segment_ids=seg)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        args = (q, k, v, dout, ref_lse, fa.flash_delta(ref_out, dout))
        o, lse = fa.flash_fwd(q, k, v, **kw)
        dk, dv = fa.flash_dkv(*args, **kw)
        tensors = {"out": o, "lse": lse, "dq": fa.flash_dq(*args, **kw), "dk": dk, "dv": dv}
        out["cases"][f"{label}/{seed}/{str(dtype)[6:]}"] = {
            name: t.cpu() for name, t in tensors.items()}
        torch.cuda.empty_cache()
    torch.save(out, path)


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    cases = {}
    for key, tensors in a["cases"].items():
        other = b["cases"].get(key, {})
        cases[key] = {name: name in other and torch.equal(t, other[name])
                      for name, t in tensors.items()}
    same = bool(cases) and a["cases"].keys() == b["cases"].keys() and all(
        all(v.values()) for v in cases.values())
    print(json.dumps({"phase": "flash_bitwise", "a": a["package"], "b": b["package"],
                      "cases": len(cases), "bitwise_equal": same, "by_case": cases}))
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
