"""Seeded random weights, made on the device in the type they are served in.

The configuration's family module gives the tree as ordered entries (tree
path, shape, dtype, init), in the layout ``repro_torch.models.Model`` takes,
which is also the layout the plain reference reads. One ``torch.Generator``
on the card fills a single flat bf16 buffer with standard normals, in
chunks of at most 2**30 elements, and then a single flat f32 buffer; each
entry is a view of its dtype's buffer, in order, scaled in place by its std,
or, for a norm weight (``families.NORM``), made ``1 + 0.1 N(0, 1)``, so
that a norm's weight counts in what is served. The same seed gives the same
weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tierbench import families

CHUNK = 1 << 30
DTYPES = (torch.bfloat16, torch.float32)


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(conf: dict, seed: int, device) -> Dict:
    """The weight tree of ``conf`` from ``seed``, on ``device``."""
    layout = families.of(conf).weight_layout(conf)
    for path, _, dtype, _ in layout:
        if dtype not in DTYPES:
            raise ValueError(f"{'.'.join(path)}: weights are drawn in {DTYPES}, not {dtype}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict = {}
    for dtype in DTYPES:
        entries = [e for e in layout if e[2] == dtype]
        total = sum(torch.Size(shape).numel() for _, shape, _, _ in entries)
        flat = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        at = 0
        for path, shape, _, init in entries:
            n = torch.Size(shape).numel()
            w = flat[at:at + n].view(shape)
            if init == families.NORM:
                w.mul_(0.1).add_(1.0)
            else:
                w.mul_(init)
            _put(tree, path, w)
            at += n
    return tree
