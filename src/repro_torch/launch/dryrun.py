"""Dry-run, after ``repro.launch.dryrun``: build every (architecture x
input-shape) cell on the ``meta`` device, count it, and write its roofline
terms on the H100.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_4b --shape decode_32k --smoke
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all               # every cell, h100x1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all    # + both pod meshes

Each cell writes ``experiments/dryrun/<arch>__<shape>__<mesh>.json``.

Meshes: ``h100x1`` is one card. The cell's program runs on ``meta`` tensors
under ``roofline.op_stats``, which counts its matmul FLOPs and the bytes of
its dispatched operations, and ``roofline.analysis`` turns them into the
H100 roofline terms. A SMOKE config (``--smoke``) is counted whole. A full
config is counted at depths 1 and 2 (1, 2 and ``hybrid_attn_every + 1`` for
the hybrid, whose shared block runs once per group) and, for a train cell
that accumulates, at 2 and 3 microbatches of its microbatch size; the counts
are then extrapolated exactly, since every layer and every microbatch
dispatches the same operations (the eager counterpart of the reference's
trip counts): a count is linear in the layers (and in the shared-block
applications), and bilinear with the microbatches. ``pod16x16`` and
``pod2x16x16`` are the reference's production meshes; they exist only
abstractly here, so they report the per-device bytes of the cell's
arguments under its specs only. The reference's XLA memory and cost
analysis, temp bytes and HLO collective bytes have no eager counterpart.
No GPU is needed and no kernel runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

MESHES = {
    "h100x1": ((1, 1), ("data", "model")),
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _pairs(args, specs):
    """(tensor, spec) for every tensor of an argument tree and its spec tree."""
    if isinstance(args, torch.Tensor):
        yield args, specs
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from _pairs(v, specs[k])
    elif isinstance(args, (list, tuple)):
        for a, s in zip(args, specs):
            yield from _pairs(a, s)
    elif dataclasses.is_dataclass(args):
        for f in dataclasses.fields(args):
            yield from _pairs(getattr(args, f.name), getattr(specs, f.name))


def arg_bytes_per_device(cell) -> int:
    """Bytes of one device's shard of every argument under the cell's specs."""
    from repro_torch.runtime import sharding as shr

    return sum(shr.per_device_bytes(spec, tuple(t.shape), t.element_size(), cell.mesh)
               for t, spec in _pairs(cell.abstract_args, cell.in_specs))


def _depth_points(cfg):
    """Depths to count at and the features a count is linear in."""
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        return [1, 2, e + 1], lambda n: [1.0, float(-(-n // e)), float(n)]
    return [1, 2], lambda n: [1.0, float(n)]


def count_cell(arch: str, shape_name: str, mesh, smoke: bool = False,
               extrapolate: bool = None) -> dict:
    """Counted FLOPs and bytes of the cell's program: whole for a SMOKE
    config, extrapolated from cut cells for a full one (or as asked)."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import cells as cells_mod
    from repro_torch.roofline import op_stats

    extrapolate = (not smoke) if extrapolate is None else extrapolate
    if not extrapolate:
        st = op_stats.analyze(cells_mod.build_cell(arch, shape_name, mesh, smoke=smoke).run)
        return {"flops": st.flops, "bytes": st.traffic_bytes, "n_ops": st.n_ops,
                "counted": "whole"}
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    shape = SHAPES[shape_name]
    parallel = cells_mod.default_parallel(cfg, shape_name, mesh)
    depths, phi = _depth_points(cfg)
    accum = parallel.grad_accum if shape.kind == "train" else 1
    if accum > 1:
        micro = shape.global_batch // accum
        accums, psi = [2, 3], (lambda a: [1.0, float(a)])
    else:
        micro, accums, psi = None, [1], (lambda a: [1.0])
    rows, ys, n_ops = [], [], 0
    for d in depths:
        for a in accums:
            cell = cells_mod.build_cell(
                arch, shape_name, mesh, smoke=smoke, depth=d,
                parallel=dataclasses.replace(parallel, grad_accum=a),
                batch_size=None if micro is None else a * micro)
            st = op_stats.analyze(cell.run)
            rows.append(np.kron(phi(d), psi(a)))
            ys.append((st.flops, st.traffic_bytes))
            n_ops += st.n_ops
    w = np.linalg.solve(np.array(rows), np.array(ys, dtype=np.float64))
    flops, nbytes = np.kron(phi(cfg.n_layers), psi(accum)) @ w
    how = f"extrapolated from depths {depths}" + (f" x microbatches {accums}" if accum > 1
                                                  else "")
    return {"flops": float(flops), "bytes": float(nbytes), "n_ops_counted": n_ops,
            "counted": how}


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             smoke: bool = False) -> dict:
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import cells as cells_mod
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.roofline import analysis as ra

    shape, axes = MESHES[mesh_name]
    mesh = make_abstract_mesh(shape, axes)
    chips = math.prod(shape)
    t0 = time.perf_counter()
    cell = cells_mod.build_cell(arch, shape_name, mesh, smoke=smoke)
    args_b = float(arg_bytes_per_device(cell))
    t_build = time.perf_counter() - t0
    print(f"[{arch} x {shape_name} x {mesh_name}] {cell.kind} ({cell.notes})")
    print(f"  argument bytes per device: {args_b:.4e}")
    if mesh_name != "h100x1":
        data = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
                "kind": cell.kind, "notes": cell.notes, "args_bytes_pd": args_b,
                "build_s": round(t_build, 2)}
    else:
        t0 = time.perf_counter()
        counted = count_cell(arch, shape_name, mesh, smoke=smoke)
        t_count = time.perf_counter() - t0
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
        mf = ra.model_flops_for(cfg, SHAPES[shape_name])
        report = ra.analyze(counted["flops"], counted["bytes"], arch, shape_name, mesh_name,
                            chips, mf, args_b, notes=cell.notes + " | " + counted["counted"])
        print("  counted: flops=%.4e bytes=%.4e (%s)" % (counted["flops"], counted["bytes"],
                                                         counted["counted"]))
        print("  roofline on %s: compute=%.4es memory=%.4es collective=%.4es -> %s | "
              "useful=%.4f fits=%s"
              % (report.device, report.compute_s, report.memory_s, report.collective_s,
                 report.bottleneck, report.useful_ratio, report.fits_hbm))
        data = report.to_json()
        data.update(kind=cell.kind, build_s=round(t_build, 2), count_s=round(t_count, 2),
                    step_time_s=report.step_time_s,
                    roofline_fraction=report.roofline_fraction,
                    **{k: v for k, v in counted.items() if k.startswith("n_ops")})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json"), "w") as f:
        json.dump(data, f, indent=2)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=list(MESHES) + ["all"], default="h100x1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="reduced configs (CI sanity)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    import repro_torch.configs as configs

    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in configs.arch_ids() for s in configs.cells_for(a)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in configs.cells_for(args.arch)]
    else:
        ap.error("--arch (and --shape) required unless --all")

    failures = []
    for mesh_name in meshes:
        for arch, shape in cells:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip {arch} x {shape} x {mesh_name} (exists)")
                continue
            try:
                run_cell(arch, shape, mesh_name, args.out, smoke=args.smoke)
            except Exception as e:  # noqa: BLE001 — report and continue
                traceback.print_exc()
                failures.append((arch, shape, mesh_name, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("dry-run OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
