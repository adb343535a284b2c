"""The op's forward, dx and dw kernels at SAN19's K = 7 maps and cotnet50's
K = 3 maps, timed in the tree the command runs from, so that two trees can
be compared on one card.

    python3 <path to>/tools/k7_probe.py TAG OUT.json [--check]

Run it from a tree's root (its ``cotnet_tpu_torch`` and ``chip_smoke.py``
are the ones imported); to compare two trees, run it from each in turns
(A, B, B, A) in one command.  It builds the kernels (``build_report``:
ptxas registers and spills), then times, with ``chip_smoke.device_ms``
(cold L2, median of 20), the forward, dx and dw at bs128 bf16 at SAN19's
four K = 7 geometries (C 64 / 128 / 256 / 512 at 56 / 28 / 14 / 7, Cw = C/8,
zero pad 3) and cotnet50's four K = 3 ones, each beside its byte bound
and the route it took.  ``--check`` also holds each launch against the
plain version (bf16 within one ulp of the largest, f32 within 1e-5 of
it, at N = 16 at SAN19's maps) and launches it twice for the same bits,
and adds the k7 tiles' edges.  Writes the rows to OUT.json, with the
card's name.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cotnet_tpu_torch.ops import _build, local_agg as la  # noqa: E402

SAN19_K7 = ((64, 56), (128, 28), (256, 14), (512, 7))
COTNET50 = ((64, 56), (128, 28), (256, 14), (512, 7))
# (N, C, Cw, H, W, dtype, padding, affine): the k7 tiles' edges, then 16
# groups, which they refuse
EDGES = ((2, 64, 8, 13, 11, torch.bfloat16, None, False),
         (1, 64, 8, 56, 56, torch.bfloat16, None, False),
         (3, 40, 5, 17, 23, torch.float32, None, False),
         (2, 16, 8, 5, 5, torch.float16, None, False),
         (2, 32, 4, 15, 9, torch.float32, (1, 3), False),
         (2, 64, 8, 13, 11, torch.bfloat16, None, True),
         (2, 64, 8, 14, 14, torch.float32, None, True),
         (2, 64, 4, 14, 14, torch.bfloat16, None, False))


def run(kern, x, w, dy, s, b, geo):
    """One launch of ``kern`` (fwd, dx or dw; with s and b, the affine
    forward, dx or dw, ds and db), its output (dw's alone)."""
    if kern == "fwd":
        return la.local_aggregate_hopper(x, w, s, b, **geo)
    need = dict(need_dx=kern == "dx", need_dw=kern == "dw")
    pick = 0 if kern == "dx" else 1
    if s is not None:
        return la.local_aggregate_bwd_affine_hopper(x, w, s, b, dy, **geo,
                                                    **need)[pick]
    return la.local_aggregate_bwd_hopper(x, w, dy, **geo, **need)[pick]


def reference(kern, x, w, dy, s, b, k, pad):
    ph, pw = pad
    xp = F.pad(x, (pw, pw, ph, ph))
    if kern == "fwd":
        return la.local_aggregate_plain(xp, w, (k, k), (1, 1), (1, 1), s, b)
    need = dict(need_dx=kern == "dx", need_dw=kern == "dw")
    if s is not None:
        r = la.local_aggregate_bwd_affine_plain(xp, w, s, b, dy, (k, k),
                                                (1, 1), **need)
    else:
        r = la.local_aggregate_bwd_plain(xp, w, dy, (k, k), (1, 1), **need)
    if kern == "dw":
        return r[1]
    return r[0][..., ph:ph + x.shape[2], pw:pw + x.shape[3]]


def case(gen, tag, check, n, c, cw, h, wd, k, dt, pad=None, affine=False,
         timed=True):
    def randn(*shape, dtype=dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    pad = pad or ((k - 1) // 2,) * 2
    ho, wo = h + 2 * pad[0] - k + 1, wd + 2 * pad[1] - k + 1
    x, w = randn(n, c, h, wd), randn(n, 1, cw, k * k, ho, wo)
    dy = randn(n, c, ho, wo)
    s = b = None
    if affine:
        s = 1.0 + 0.5 * randn(n, 1, cw, k * k, dtype=torch.float32)
        b = 0.5 * randn(n, 1, cw, k * k, dtype=torch.float32)
    geo = dict(kernel_size=(k, k), dilation=(1, 1), padding=pad)
    rows = []
    for kern in ("fwd", "dx", "dw"):
        which = "dw_affine" if kern == "dw" and affine else kern
        row = dict(kernel=kern, n=n, c=c, cw=cw, h=h, w=wd, k=k, pad=pad,
                   dtype=str(dt).replace("torch.", ""), affine=affine,
                   route=la.kernel_route(which, x, w, **geo))
        got = run(kern, x, w, dy, s, b, geo)
        torch.cuda.synchronize()
        if check:
            ref = reference(kern, x, w, dy, s, b, k, pad)
            what = f"{kern} {row}"
            row["max_abs_err"] = cs.check_close(what, got, ref, dt)[0]
            scale = float(ref.float().abs().max())
            row["err_of_max"] = row["max_abs_err"] / scale
            if dt == torch.float32 and row["max_abs_err"] > 1e-5 * scale:
                raise AssertionError(f"f32 beyond 1e-5 of the largest at "
                                     f"{what}")
            if not torch.equal(run(kern, x, w, dy, s, b, geo), got):
                raise AssertionError(f"other bits on a second launch at "
                                     f"{what}")
            row["same_bits"] = True
        if timed:
            row["ms"] = cs.device_ms(lambda: run(kern, x, w, dy, s, b, geo))
            # fwd reads x and w, dx dy and w, dw x and dy; each writes its
            # output (the affine's s and b, ds and db left out)
            ins = {"fwd": (x, w), "dx": (dy, w), "dw": (x, dy)}[kern]
            nbytes = (sum(t.numel() for t in ins) + got.numel()) \
                * x.element_size()
            row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
            row["share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"[{tag}] {json.dumps(row)}", flush=True)
    return rows


def main():
    tag, out = sys.argv[1], sys.argv[2]
    check = "--check" in sys.argv[3:]
    t0 = time.time()
    cs.build_report(_build)
    print(f"[{tag}] build {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for c, hw in SAN19_K7:
        rows += case(gen, tag, check, 128, c, c // 8, hw, hw, 7,
                     torch.bfloat16)
    for c, hw in COTNET50:
        rows += case(gen, tag, check, 128, c, c // 8, hw, hw, 3,
                     torch.bfloat16)
    if check:
        for c, hw in SAN19_K7:
            rows += case(gen, tag, check, 16, c, c // 8, hw, hw, 7,
                         torch.float32, timed=False)
        for n, c, cw, h, wd, dt, pad, affine in EDGES:
            rows += case(gen, tag, check, n, c, cw, h, wd, 7, dt, pad=pad,
                         affine=affine, timed=False)
    with open(out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "power_limit": cs.nvidia_smi(), "rows": rows}, f)
    print(f"[{tag}] done {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
