#!/usr/bin/env python3
"""Time variants of the fused embed op's kernels on one CUDA card.

    python3 tools/embed_gn_variants.py 'NAME|FILE|OLD|NEW' ...

Each argument is an edit of a variant: a copy of
``cotnet_tpu_torch/ops/csrc`` in which FILE has the text OLD (which must
occur, and holds no ``|``) replaced by NEW; the edits that share a NAME
make one variant.  The sources are prepared, and every edit checked,
before the card is asked for.  The script builds every variant's
``local_agg_embed_gn`` library with the port's nvcc flags, then times
the op at the path-B geometries of
``chip_smoke.embed_gn_cases()`` in turns: the tree's kernels, each
variant, the tree's again, all in one process on one card.  Per case and
run it prints the kernel-against-plain check, the op's cold-L2 time
(``chip_smoke.device_ms``), its statistics and aggregation kernels'
device time (``chip_smoke.kernel_ms_by_name``) and, where a statistics
pass runs, that pass alone (``ops.local_agg.embed_gn_statistics``).  The
variants' sources go to ``chip_tree/variants/``, which git ignores.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from cotnet_tpu_torch.ops import _build, local_agg as la  # noqa: E402

LIB = "local_agg_embed_gn"
PATH_B_CASES = len(chip_smoke.FUSED_MODELS) * 4


def prepare_variants(args) -> dict:
    """Each variant's copy of the sources with its edits made; by name."""
    variants = {}
    for arg in args:
        name, fname, old, new = arg.split("|", 3)
        src = ROOT / "chip_tree" / "variants" / name
        if name not in variants:
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, src)
            variants[name] = src
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {fname}")
        path.write_text(text.replace(old, new))
    return variants


def build_variant(src: Path) -> ctypes.CDLL:
    so = src / f"lib{LIB}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src / f"{LIB}.cu")], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(so))


def time_cases(label: str):
    gen = torch.Generator(device="cuda").manual_seed(9)
    for cs in chip_smoke.embed_gn_cases()[:PATH_B_CASES]:
        args, kw, geometry = chip_smoke.embed_gn_inputs(cs, gen)

        def run():
            return la.local_aggregate_embed_gn(*args, impl="hopper", **kw)

        with torch.no_grad():
            got = run()
            ref = la.local_aggregate_embed_gn(*args, impl="torch", **kw)
            scale = float(ref.float().abs().max())
            bad = int(((got.float() - ref.float()).abs()
                       > 4e-3 * scale + 8e-3 * ref.float().abs()).sum())
            ms = chip_smoke.device_ms(run)
            split = chip_smoke.kernel_ms_by_name(
                run, chip_smoke.EMBED_GN_STATS + chip_smoke.EMBED_GN_AGG)
            geo = {key: (v, v) if key != "groups" else v
                   for key, v in kw.items()}
            alone = ""
            if la.embed_gn_workspace_bytes(*args[:3], **geo):
                alone = (", statistics pass alone " + chip_smoke.fmt_ms(
                    chip_smoke.device_ms(lambda: la.embed_gn_statistics(
                        *args[:4], **geo))))
        stats = [split[name] for name in chip_smoke.EMBED_GN_STATS]
        print(f"{label} {geometry}: {bad} elements off, {ms:.4f} ms, stats "
              f"{chip_smoke.fmt_ms(None if None in stats else sum(stats))}, "
              f"aggregation "
              f"{chip_smoke.fmt_ms(split[chip_smoke.EMBED_GN_AGG[0]])}"
              f"{alone}", flush=True)


def main() -> int:
    variants = prepare_variants(sys.argv[1:])
    if not torch.cuda.is_available():
        print("embed_gn_variants: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi(), flush=True)
    tree = _build.load(LIB)
    built = [(name, build_variant(src)) for name, src in variants.items()]
    time_cases("tree")
    for name, lib in built:
        _build._LIBS[LIB] = lib
        time_cases(name)
    _build._LIBS[LIB] = tree
    time_cases("tree again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
