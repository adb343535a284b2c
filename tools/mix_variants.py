#!/usr/bin/env python3
"""Time variants of the mix op's kernels on one CUDA card.

    python3 tools/mix_variants.py 'NAME|FILE|OLD|NEW' ...

Each argument is an edit of a variant, as ``tools/embed_gn_variants.py``
takes them: a copy of ``cotnet_tpu_torch/ops/csrc`` in which FILE has the
text OLD replaced by NEW; the edits that share a NAME make one variant
(an OLD of ``#``, with FILE ``local_agg_mix.cu``, puts NEW before the
file's first line, for a ``#define``).  The sources are prepared, and
every edit checked, before the card is asked for.  The script builds every
variant's ``local_agg_mix`` library with the port's nvcc flags and prints
what ptxas says of its kernels (registers, spills), then times the mix's
forward, dx and dw at cotnet50's four geometries (bf16, bs128, the
weights separate: ``chip_smoke.mix_cases()``'s main cases) in turns: the
tree's kernels, each variant, the tree's again, all in one process on one
card, with the pointwise route (the first kernels) timed once beside them.
Per case and run it checks the kernel against the pointwise route (the
forward and dw bit for bit, dx at ``chip_smoke.check_close``'s gate) and
prints the cold-L2 time (``chip_smoke.device_ms``).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from cotnet_tpu_torch.ops import _build, local_agg as la  # noqa: E402
from embed_gn_variants import prepare_variants  # noqa: E402

LIB = "local_agg_mix"


def prepare(args) -> dict:
    """The variants' sources; an edit whose OLD is ``#`` prepends NEW."""
    prepends, edits = {}, []
    for arg in args:
        name, fname, old, new = arg.split("|", 3)
        if old == "#":
            prepends.setdefault((name, fname), []).append(new)
            edits.append(f"{name}|{fname}|#include|#include")
        else:
            edits.append(arg)
    variants = prepare_variants(edits)
    for (name, fname), lines in prepends.items():
        path = variants[name] / fname
        path.write_text("\n".join(lines) + "\n" + path.read_text())
    return variants


def build_variant(src: Path) -> ctypes.CDLL:
    so = src / f"lib{LIB}.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src / f"{LIB}.cu")], check=True,
                         capture_output=True, text=True)
    report(src.name, out.stdout + out.stderr)
    return ctypes.CDLL(str(so))


def report(label: str, ptxas: str):
    fn = None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and "_mix_" in fn and ("spill" in line or "Used" in line):
            print(f"{label} ptxas {fn}: "
                  f"{line.replace('ptxas info    :', '').strip()}",
                  flush=True)


def time_cases(label: str, pointwise: bool = False):
    cases = [cs for cs in chip_smoke.mix_cases()
             if cs.get("main") and not cs["merged"]]
    for i, cs in enumerate(cases):
        x, w1, w2, dy = chip_smoke.mix_tensors(cs, seed=60 + i)
        for kernel in ("fwd", "dx", "dw"):
            need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")
            pick = slice(0, 1) if kernel != "dw" else slice(1, 3)

            def run(pointwise=pointwise):
                if kernel == "fwd":
                    return (la.local_aggregate_mix_hopper(
                        x, w1, w2, pointwise=pointwise),)
                return la.local_aggregate_mix_bwd_hopper(
                    x, w1, w2, dy, pointwise=pointwise, **need)

            with torch.no_grad():
                got = run()[pick]
                ref = run(pointwise=True)[pick]
                if kernel != "dx":
                    same = all(torch.equal(a, b) for a, b in zip(got, ref))
                    check = f"same bits as pointwise: {same}"
                else:
                    err = chip_smoke.check_close(
                        f"{label} dx", got[0], ref[0], cs["dtype"])[0]
                    check = f"max|err| against pointwise {err:.3g}"
                ms = chip_smoke.device_ms(run)
            print(f"{label} {kernel} N={cs['n']} C={cs['c']} "
                  f"{cs['h']}x{cs['w']}: {ms:.4f} ms; {check}", flush=True)


def main() -> int:
    variants = prepare(sys.argv[1:])
    if not torch.cuda.is_available():
        print("mix_variants: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi(), flush=True)
    report("tree", _build.build(LIB))
    tree = _build.load(LIB)
    built = [(name, build_variant(src)) for name, src in variants.items()]
    time_cases("pointwise route", pointwise=True)
    time_cases("tree")
    for name, lib in built:
        _build._LIBS[LIB] = lib
        time_cases(name)
    _build._LIBS[LIB] = tree
    time_cases("tree again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
