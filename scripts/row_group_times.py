"""Device times of the row-group kernels (#2 ``quant_pages``, #3
``transcode_pages``, #4 ``dequant_pages``, #6 ``cxl_encode_pages``, #7
``cxl_decode_pages``) at the serving runs' shapes, on a GPU, for one copy of
the port's package, so that two trees can be compared in one call.

    python scripts/row_group_times.py                       # this checkout
    python scripts/row_group_times.py --src OTHER/src --label parent
    python scripts/row_group_times.py --sweep               # + row-count sweep

It imports ``repro_torch`` from ``--src`` (this checkout's ``src`` by
default; the wrappers' signatures are the same across trees), checks each
kernel byte-equal to its plain version on the timed inputs, and times it with
``chip_smoke.time_ms`` (median of 20, L2 flushed, behind a ~1 ms spin). The
shapes are the largest calls of ``chip_smoke.py``'s runs: transcode cohorts
(160, 16, 20, 128) and (64, 16, 32, 64) in both directions, page-outs
(2720, 16, 20, 128) and (224, 16, 32, 64) in bf16 and in f32, dequant
payloads (32, 16, 20, 64) and (11, 16, 32, 32) int4 -> f32 and the int8
batch (``DEQUANT_INT8``) in f32 and bf16, each int8 one beside one
``torch.mul``, the cxl encode of (32, 16, 32, 64) pages in bf16 and f32,
and the cxl decode (int8 -> f32) of (19, 16, 32, 64) and (32, 16, 20, 128)
payloads beside one ``torch.mul``, all through the wrappers, so each tree is
timed at the geometry it ships. Where the package has
``quant_page.empty_launch`` an empty one-block launch is timed too, as the
floor of a small launch. ``--sweep`` adds quant (bf16 -> int8) and transcode
(int8 -> int4) at 1/4x to 4x those row counts. Prints one JSON line (and
writes it to ``build/row_group_times/<label>.json``), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

QUANT = {"hd128": (2720, 16, 20, 128), "hd64": (224, 16, 32, 64)}
TRANSCODE = {"hd128": (160, 16, 20, 128), "hd64": (64, 16, 32, 64)}
DEQUANT_INT4 = {"hd128": (32, 16, 20, 64), "hd64": (11, 16, 32, 32)}  # payload shapes
DEQUANT_INT8 = (32, 16, 20, 128)
CXL_ENCODE = (32, 16, 32, 64)
CXL_DECODE = {"hd64": (19, 16, 32, 64), "hd128": (32, 16, 20, 128)}
SWEEP = (0.25, 0.5, 1, 2, 4)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("row_group_times: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import cxl_line, dequant_page, quant_page, ref, transcode_page

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # after repro_torch: its path insert does not rebind the package

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "src": args.src, "card": card,
           "quant": {}, "transcode": {}, "dequant": {}, "cxl_encode": {}, "cxl_decode": {}}
    if hasattr(quant_page, "empty_launch"):
        out["floor_ms"] = cs.time_ms(lambda: quant_page.empty_launch("cuda"))

    def quant_row(shape, dtype):
        pages = torch.randn(shape, generator=g, device="cuda").to(dtype)
        kp, ks = quant_page.quant_pages(pages, 8)
        rp, rs = ref.quant_kv_page(pages, 8)
        if not (torch.equal(kp, rp) and torch.equal(ks, rs)):
            raise SystemExit(f"quant_pages {shape} {dtype}: differs from the plain version")
        n = pages.numel()
        bound, _ = cs.bound_ms(n * pages.element_size() + n + n // shape[-1] * 4, 6 * n)
        return {"ms": cs.time_ms(lambda: quant_page.quant_pages(pages, 8)), "bound_ms": bound,
                "shape": list(shape), "dtype": str(dtype)}

    def transcode_row(shape, src, dst):
        pay, sc = ref.quant_kv_page(torch.randn(shape, generator=g, device="cuda"), src)
        kp, ks = transcode_page.transcode_pages(pay, sc, src, dst)
        rp, rs = ref.transcode_kv_page(pay, sc, src, dst)
        if not (torch.equal(kp, rp) and torch.equal(ks, rs)):
            raise SystemExit(f"transcode_pages {shape} {src}->{dst}: differs from the plain version")
        elems, rows = sc.numel() * shape[-1], sc.numel()
        in_b = (elems if src == 8 else elems // 2) + rows * 4
        out_b = (elems if dst == 8 else elems // 2) + rows * 4
        bound, _ = cs.bound_ms(in_b + out_b, 8 * elems)
        return {"ms": cs.time_ms(lambda: transcode_page.transcode_pages(pay, sc, src, dst)),
                "bound_ms": bound, "shape": list(shape), "dir": f"int{src}->int{dst}"}

    def dequant_row(shape, bits, out_dtype):
        hd = shape[-1] * (1 if bits == 8 else 2)
        pay, sc = ref.quant_kv_page(torch.randn(shape[:-1] + (hd,), generator=g, device="cuda"),
                                    bits)
        want = dequant_page.dequant_pages_plain(pay, sc, bits, out_dtype)

        def call():
            return dequant_page.dequant_pages(pay, sc, bits, out_dtype)

        if not torch.equal(call(), want):
            raise SystemExit(f"dequant_pages {shape} int{bits} -> {out_dtype}: differs from "
                             "the plain version")
        elems = sc.numel() * hd
        bound, _ = cs.bound_ms(pay.numel() + sc.numel() * 4 + elems * out_dtype.itemsize, elems)
        row = {"ms": cs.time_ms(call), "bound_ms": bound, "shape": list(shape),
               "dir": f"int{bits}->{out_dtype}"}
        if bits == 8:
            lib = cs.library_dequant(pay, sc, bits, out_dtype)
            row["library_ms"] = cs.time_ms(lib)
        return row

    def cxl_encode_row(shape, dtype):
        pages = torch.randn(shape, generator=g, device="cuda").to(dtype)
        got, want = cxl_line.cxl_encode_pages(pages), ref.cxl_encode_kv_page(pages)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"cxl_encode_pages {shape} {dtype}: differs from the plain version")
        n = pages.numel()
        bound, _ = cs.bound_ms(n * pages.element_size() + n + n // shape[-1] * 4
                               + n // ref.CXL_LINE_ELEMS * 4, 7 * n)
        return {"ms": cs.time_ms(lambda: cxl_line.cxl_encode_pages(pages)), "bound_ms": bound,
                "shape": list(shape), "dtype": str(dtype)}

    def cxl_decode_row(shape):
        pay, sc = ref.quant_kv_page(torch.randn(shape, generator=g, device="cuda"), 8)

        def call():
            return cxl_line.cxl_decode_pages(pay, sc)

        if not torch.equal(call(), ref.cxl_decode_kv_page(pay, sc)):
            raise SystemExit(f"cxl_decode_pages {shape}: differs from the plain version")
        n = pay.numel()
        bound, _ = cs.bound_ms(n + sc.numel() * 4 + n * 4, n)
        return {"ms": cs.time_ms(call), "bound_ms": bound, "shape": list(shape),
                "library_ms": cs.time_ms(cs.library_dequant(pay, sc, 8, torch.float32))}

    for key, shape in QUANT.items():
        out["quant"][key] = {"bf16": quant_row(shape, torch.bfloat16),
                             "f32": quant_row(shape, torch.float32)}
        torch.cuda.empty_cache()
    for key, shape in TRANSCODE.items():
        out["transcode"][key] = {"8to4": transcode_row(shape, 8, 4),
                                 "4to8": transcode_row(shape, 4, 8)}
    for key, shape in DEQUANT_INT4.items():
        out["dequant"][key] = {"int4_f32": dequant_row(shape, 4, torch.float32)}
    out["dequant"]["int8"] = {"f32": dequant_row(DEQUANT_INT8, 8, torch.float32),
                              "bf16": dequant_row(DEQUANT_INT8, 8, torch.bfloat16)}
    out["cxl_encode"] = {"bf16": cxl_encode_row(CXL_ENCODE, torch.bfloat16),
                         "f32": cxl_encode_row(CXL_ENCODE, torch.float32)}
    out["cxl_decode"] = {key: cxl_decode_row(shape) for key, shape in CXL_DECODE.items()}
    if args.sweep:
        out["sweep"] = {"quant_bf16": {}, "transcode_8to4": {}}
        for key in QUANT:
            for f in SWEEP:
                qs = (max(1, int(QUANT[key][0] * f)),) + QUANT[key][1:]
                out["sweep"]["quant_bf16"][f"{key} x{f}"] = quant_row(qs, torch.bfloat16)
                torch.cuda.empty_cache()
                ts = (max(1, int(TRANSCODE[key][0] * f)),) + TRANSCODE[key][1:]
                out["sweep"]["transcode_8to4"][f"{key} x{f}"] = transcode_row(ts, 8, 4)
    line = json.dumps(out)
    dest = ROOT / "build" / "row_group_times"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.label}.json").write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
