"""Where one launch of the split attention block spends its time, on a GPU.

Builds an instrumented copy of ``src/repro_torch/csrc`` under
``build/attn_split_clocks/`` (the committed sources stay as they are): block
(0, 0) of the per-pool kernel stores ``clock64()`` at each phase boundary of
``split_attention`` (work list, q load, each item's copy wait and compute,
partial sums, cluster sync, merge weights, outputs). It then launches the
kernel at the qwen1_5_4b page shape [., 16, 20, 128], B = 2, on an int8 pool
for a few (table width, valid pages) pairs, the L2 flushed before each
launch as ``chip_smoke.time_ms`` does, and prints the cycles of rank 0 of
sequence 0 from the start of the block, with the device time of the launch.

    python scripts/attn_split_clocks.py        # from the root of a checkout
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

OUT = ROOT / "build" / "attn_split_clocks"
# (anchor line in attn_split.cuh, phase index stored before it)
MARKS = (
    ("  const SplitLayout& L = p.lay;\n", 0),
    ("  if (lo < hi) split_fetch(p, kinds, slots, lo, b, rlen, smem);\n", 1),
    ("  // Pipelined walk over this rank's items.\n", 2),
    ("  // This rank's (acc, m, l): the TG partials", 20),
    ("  cluster.sync();\n\n  // Every rank's (m, l)", 21),
    ("  for (int h = threadIdx.x; h < p.H; h += nt) {\n    float m_tot", 22),
    ("  // Outputs of this rank's slice", 23),
    ("  cluster.sync();  // no rank leaves", 24),
)
NAMES = {0: "start", 1: "work list", 2: "q loaded", 20: "items done", 21: "partials summed",
         22: "cluster sync + (m, l) gathered", 23: "merge weights", 24: "outputs"}
ITEM_WAIT = "    const int i = it - lo;\n"
ITEM_DONE = "    if (p.NS == 1 && it + 1 < hi) {\n"


def instrumented_library() -> ctypes.CDLL:
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(build.CSRC, OUT)
    src = (OUT / "attn_split.cuh").read_text()
    src = src.replace("namespace cg = cooperative_groups;\n", (
        "namespace cg = cooperative_groups;\n__device__ long long clocks_at[64];\n"
        "#define CLOCK(i) do { if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
        "clocks_at[i] = clock64(); } while (0)\n"), 1)
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in attn_split.cuh: {anchor!r}")
        src = src.replace(anchor, f"  CLOCK({i});\n" + anchor)
    for anchor, code in ((ITEM_WAIT, "    if (i < 8) CLOCK(4 + 2 * i);\n"),
                         (ITEM_DONE, "    if (i < 8) CLOCK(5 + 2 * i);\n")):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in attn_split.cuh: {anchor!r}")
        src = src.replace(anchor, (anchor + code) if anchor == ITEM_WAIT else (code + anchor))
    (OUT / "attn_split.cuh").write_text(src)
    cu = OUT / "paged_quant_attention.cu"
    cu.write_text(cu.read_text() + (
        '\nextern "C" int clocks_read(long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, clocks_at, sizeof(long long) * 64);\n}\n"))
    lib_path = OUT / "libpaged_quant_attention_clocks.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(OUT), "-o", str(lib_path),
                    str(cu)], check=True)
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_split_clocks: needs a CUDA GPU", file=sys.stderr)
        return 2
    lib = instrumented_library()
    build._LIBS["paged_quant_attention"] = lib  # the wrapper launches the instrumented copy
    g = torch.Generator(device="cuda").manual_seed(0)
    kv = h = 20
    hd, t, b = 128, 16, 2
    k8, s8k = ref.quant_kv_page(torch.randn((256, t, kv, hd), generator=g, device="cuda"), 8)
    v8, s8v = ref.quant_kv_page(torch.randn((256, t, kv, hd), generator=g, device="cuda"), 8)
    q = torch.randn((b, h, hd), generator=g, device="cuda").to(torch.bfloat16)
    names = dict(NAMES)
    for i in range(8):
        names[4 + 2 * i] = f"item {i} copy landed"
        names[5 + 2 * i] = f"item {i} computed"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for mp, n in ((2, 0), (2, 2), (8, 8), (64, 33)):
        table = torch.randint(0, 256, (b, mp), generator=g, device="cuda", dtype=torch.int32)
        args = (q, k8, s8k, v8, s8v, table, torch.tensor([n, n], dtype=torch.int32,
                                                          device="cuda"), 8)
        ms = cs.time_ms(lambda: pa.paged_quant_attention_launch(*args))
        buf = (ctypes.c_longlong * 64)()
        scratch.zero_()
        pa.paged_quant_attention_launch(*args)
        torch.cuda.synchronize()
        if lib.clocks_read(buf):
            raise RuntimeError("reading the clocks failed")
        t0 = buf[0]
        row = ", ".join(f"{names[i]} {buf[i] - t0}" for i in sorted(names)
                        if t0 <= buf[i] < t0 + 10**8)
        print(f"MP={mp} n={n} S={pa.LAST_CLUSTER['paged_quant_attention']}: {ms:.4f} ms; "
              f"cycles of rank 0: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
