"""The tiered decode step as one CUDA graph, captured once and replayed per
token: the port's counterpart of the reference engine's compiled step,
``jax.jit(serve_rt.make_tiered_decode_step(...))`` (``repro.serving.engine``).

``GraphedStep`` wraps the eager step on the card
(``runtime.serve.make_tiered_decode_step(..., device="cuda")``) and keeps
its signature and its results: step(params, token, tkv, extra_state) ->
(logits, tkv', extra_state', telemetry).

* Capture. The first call of a route runs the eager step once on a side
  stream (the warm-up: cuBLAS's workspaces, the attention kernels'
  first-launch caches in ``csrc/attn_split.cuh``) and returns that step's
  result; then it captures the whole step, every layer, with
  ``torch.cuda.graph``. Later calls replay the graph.
* Operands held by address: the class buffers (``c8_*``, ``c4_*``), the host
  summary and the params, which the cache edits in place. Every call checks
  their ``data_ptr``s (and the shapes and dtypes of the copied operands); if
  one changed, the step is captured again and counted in ``captures``, never
  replayed over a stale address.
* Operands copied in: the token, the page tables and counts, the recent
  window and lengths, and the hybrid's SSM state. The cache, the engine and
  the step itself replace these between steps, so each replay first copies
  them into the graph's static inputs.
* Outputs are cloned out of the graph's memory: the engine hands the recent
  window to page-out, and the async pipeline may still hold it at the next
  replay.
* Route: the process-wide switches the step reads (``ops.use_fused``, the MoE
  int8 wire) are fixed at capture; each route has its own graph.
* Launches: a capture runs no kernel, so it counts none
  (``build.recording_launches``); each replay adds the launches its graph
  holds (``build.count_replay``) and restores the cluster sizes seen at
  capture (``paged_attention.LAST_CLUSTER``).

On the CPU nothing is captured. The same static-buffer plumbing runs, and a
replay runs the eager step on the static inputs and copies its results into
the static outputs, as a graph would. The engine keeps the eager step there;
tests call this class directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import moe
from repro_torch.runtime.serve import CLASS_FIELDS, TieredKVState

# State fields read at their address (edited in place by the cache).
HELD_FIELDS = tuple(f"{c}_{f}" for c in ("c8", "c4") for f in CLASS_FIELDS) + ("host_summary",)
# State fields copied into static inputs before each replay.
COPIED_FIELDS = tuple(f.name for f in dataclasses.fields(TieredKVState)
                      if f.name not in HELD_FIELDS)


def route() -> str:
    """The decode route the step would take now."""
    name = "fused" if kops.fused_route() else "per_pool"
    return name if moe.A2A_WIRE_INT8 else name + "+no_wire"


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for c in tree:
            yield from _tensors(c)


def _key(params, token, tkv: TieredKVState, extra) -> tuple:
    """What a graph is valid for: the addresses of the held operands and
    the shapes and dtypes of the copied ones."""
    held = tuple(t.data_ptr() for t in _tensors(params))
    held += tuple(getattr(tkv, f).data_ptr() for f in HELD_FIELDS)
    copied = [token, *(getattr(tkv, f) for f in COPIED_FIELDS), *_tensors(extra)]
    return held, tuple((tuple(t.shape), t.dtype) for t in copied)


@dataclasses.dataclass
class _Graph:
    key: tuple
    token: torch.Tensor  # static inputs; the held fields of ``tkv`` are the live tensors
    tkv: TieredKVState
    extra: Optional[tuple]
    out: tuple  # static outputs
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    clusters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def produced(self, out) -> List[torch.Tensor]:
        """The tensors ``out`` holds that the step made (not its inputs)."""
        logits, tkv, extra, telemetry = out
        made = [logits]
        made += [getattr(tkv, f.name) for f in dataclasses.fields(TieredKVState)
                 if getattr(tkv, f.name) is not getattr(self.tkv, f.name)]
        if extra is not self.extra:
            made += list(extra)
        return made + [telemetry[k] for k in sorted(telemetry)]

    def results(self, out, tkv: TieredKVState, extra, fresh: Callable):
        """``out`` as the eager step on (tkv, extra) returns it: the
        step's inputs mapped back to the caller's, what it made through
        ``fresh``."""
        logits, otkv, oextra, telemetry = out
        new = {f.name: fresh(getattr(otkv, f.name)) for f in dataclasses.fields(TieredKVState)
               if getattr(otkv, f.name) is not getattr(self.tkv, f.name)}
        return (fresh(logits), dataclasses.replace(tkv, **new),
                extra if oextra is self.extra else tuple(fresh(x) for x in oextra),
                {k: fresh(v) for k, v in telemetry.items()})


class GraphedStep:
    """The tiered decode step, captured per route and replayed (see the
    module docstring). ``captures`` counts the captures per route,
    ``replays`` the replays, ``capture_s`` the host seconds the captures
    took (the warm-up steps not included)."""

    def __init__(self, step: Callable, device="cuda"):
        self.step = step
        self.device = resolve_device(device)
        self.graphs: Dict[str, _Graph] = {}
        self.captures: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0

    def __call__(self, params, token, tkv: TieredKVState, extra_state=None):
        r = route()
        key = _key(params, token, tkv, extra_state)
        g = self.graphs.get(r)
        if g is None or g.key != key:
            # A moved operand or a new route: capture (again). The old
            # graph's memory goes back first.
            self.graphs.pop(r, None)
            del g
            g, first = self._capture(key, params, token, tkv, extra_state)
            self.graphs[r] = g
            self.captures[r] = self.captures.get(r, 0) + 1
            return first
        g.token.copy_(token)
        for f in COPIED_FIELDS:
            getattr(g.tkv, f).copy_(getattr(tkv, f))
        for s, x in zip(_tensors(g.extra), _tensors(extra_state)):
            s.copy_(x)
        self._replay(g, params)
        return g.results(g.out, tkv, extra_state, torch.clone)

    def _capture(self, key, params, token, tkv, extra):
        """Static inputs from the live operands, the warm-up step and the
        capture. Returns the graph and the first step's result."""
        st_tkv = dataclasses.replace(tkv, **{f: getattr(tkv, f).clone() for f in COPIED_FIELDS})
        st_extra = None if extra is None else tuple(x.clone() for x in extra)
        st_token = token.clone()
        if self.device.type != "cuda":
            out = self.step(params, st_token, st_tkv, st_extra)
            g = _Graph(key, st_token, st_tkv, st_extra, out)
            return g, g.results(out, tkv, extra, torch.clone)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = self.step(params, st_token, st_tkv, st_extra)
        main.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with build.recording_launches() as launches:
            with torch.cuda.graph(graph):
                out = self.step(params, st_token, st_tkv, st_extra)
        self.capture_s += time.perf_counter() - t0
        g = _Graph(key, st_token, st_tkv, st_extra, out, graph,
                   {k: n for k, n in launches.items() if n},
                   {k: c for k, c in pa.LAST_CLUSTER.items() if launches[k]})
        # The warm-up's outputs live outside the graph's pool: no clone. They
        # were allocated on ``side`` and are used on ``main`` from here on, so
        # their blocks must not go back to ``side``'s pool while work queued
        # on ``main`` may still read them.
        for t in g.produced(first):
            t.record_stream(main)
        return g, g.results(first, tkv, extra, lambda x: x)

    def _replay(self, g: _Graph, params) -> None:
        self.replays += 1
        if g.graph is None:
            new = self.step(params, g.token, g.tkv, g.extra)
            for s, x in zip(g.produced(g.out), g.produced(new)):
                s.copy_(x)
            return
        g.graph.replay()
        build.count_replay(g.launches)
        pa.LAST_CLUSTER.update(g.clusters)
