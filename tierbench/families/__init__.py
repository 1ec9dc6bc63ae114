"""Model families, one module a family, found by a configuration's
``family`` key. Everything
the harness derives from a model's shape comes from the module, so a new
family is a new file here. Each module gives, as functions of the
configuration (``configs/<name>.json``, a dict):

    model_config(conf)  the port's ``repro_torch.configs.base.ModelConfig``
    weight_layout(conf) [(tree path, shape, dtype, init)], in the order
                        ``weights.make`` draws them; ``init`` is a normal's
                        std or ``NORM`` (``1 + 0.1 N(0, 1)``, a norm weight)
    shape(conf)         ``Shape``: what the cache and the readers need
    prefill(conf, s)    (FLOPs, bytes) of one prefill of ``s`` tokens
    decode_step(conf, slots, keys, kv_bytes)
                        (FLOPs, bytes) of one decode step over ``slots``
                        batch rows, ``keys`` attended keys summed over
                        attention layers and active slots and ``kv_bytes`` of
                        cache read; ``keys`` counts every key of a held
                        page, so in a window layer it includes the masked
                        head of the page that straddles the window's start,
                        at most ``page_tokens - 1`` keys a layer and slot
    weight_bytes(conf)  bytes a forward reads of weights
"""

from __future__ import annotations

import dataclasses
import importlib

NORM = "norm"


@dataclasses.dataclass(frozen=True)
class Shape:
    """The attention shape the cache holds: ``layers`` attention layers that
    hold KV, of ``heads`` query and ``kv`` KV heads of ``hd``."""

    layers: int
    heads: int
    kv: int
    hd: int


def of(conf: dict):
    """The family module of ``conf``."""
    return importlib.import_module(f"{__name__}.{conf['family']}")
